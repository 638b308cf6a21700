"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips, with its reason, where there is no CUDA
device (as on a CPU-only host).  Run on a GPU host with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

The first test builds the kernels from ``src/repro_torch/csrc`` (seconds).
``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import Calibrator, QuantPolicy, Taps, quantize_model
from repro_torch.data import make_corpus, pad_batch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.int8_matmul import int8_matmul_cuda
from repro_torch.kernels.quantize import (
    quantize_rowwise_cuda,
    quantize_static_cuda,
)
from repro_torch.models import EncDecLM
from repro_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K", [(1, 64), (12, 200), (300, 512)])
def test_quantizers_exact(gen, dtype, M, K):
    x = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(dtype)
    q = quantize_static_cuda(x, 2.5)
    assert torch.equal(q, ref.ref_quantize_static(x, 2.5))
    q, s = quantize_rowwise_cuda(x)
    rq, rs = ref.ref_quantize_rowwise(x)
    assert torch.equal(q, rq) and torch.equal(s, rs)


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (16, 130, 130),
                                   (77, 512, 200)])
def test_int8_matmul_exact(gen, M, K, N):
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    acc = int8_matmul_cuda(a, 1.0, b, torch.ones((1, N), device="cuda"))
    assert torch.equal(acc.double(),
                       torch.matmul(a.double(), b.double()).float().double())
    a_s = torch.rand((M, 1), generator=gen, device="cuda") * 0.05
    b_s = torch.rand((1, N), generator=gen, device="cuda") * 0.05
    bias = torch.randn((N,), generator=gen, device="cuda")
    for zp in (None, 3.0):
        got = int8_matmul_cuda(a, a_s, b, b_s, zp, bias)
        want = ref.ref_int8_matmul(a, a_s, b, b_s, zp, bias)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("H,HKV", [(8, 8), (8, 2)])
def test_decode_attention_close(gen, H, HKV):
    B, S, dh = 5, 70, 64
    kq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, HKV, dh), generator=gen,
                       device="cuda", dtype=torch.int8)
    ks = torch.rand((B, S, HKV), generator=gen, device="cuda") * 0.02
    vs = torch.rand((B, S, HKV), generator=gen, device="cuda") * 0.02
    lengths = torch.tensor([1, 64, 65, 70, 33], dtype=torch.int32,
                           device="cuda")
    q = torch.randn((B, H, dh), generator=gen, device="cuda")
    got = decode_attention_cuda(q, kq, ks, vq, vs, lengths, sm_scale=0.125)
    want = ref.ref_decode_attention(q, kq, ks, vq, vs, lengths, 0.125)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_engine_runs_through_every_kernel(gen):
    cfg = get_config("transformer-base").reduced(vocab=512, d_model=128,
                                                  head_dim=32,
                                                  dtype="bfloat16")
    model = EncDecLM(cfg)
    params = model.init(gen)
    corpus = make_corpus(4, cfg.vocab, seed=1)
    src, lens = pad_batch([s.src for s in corpus])
    batch = {"src_tokens": src, "src_lengths": lens}
    ops.reset_launch_counts()
    qp, ctx = quantize_model(params, {}, QuantPolicy(act_quant="dynamic"))
    ServingEngine(model, qp, quant=ctx, max_len=32).generate_beam(
        batch, beam=2, max_new_tokens=4)
    cal = Calibrator()
    taps = Taps()
    model.forward(params, {"src_tokens": torch.as_tensor(src, device="cuda"),
                           "tgt_tokens": torch.as_tensor(src, device="cuda")},
                  taps=taps)
    cal.observe_taps(taps)
    qp, ctx = quantize_model(params, cal.compute("symmetric"),
                             QuantPolicy(act_quant="static"))
    ServingEngine(model, qp, quant=ctx, max_len=32).generate(
        batch, max_new_tokens=4)
    assert all(n > 0 for n in ops.launch_counts().values()), \
        ops.launch_counts()
