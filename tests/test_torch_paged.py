"""The port's paged KV cache, its page allocator, the contiguous slot
operations of continuous serving, and the plain version of K5 against the
JAX package.

Every input is made with numpy from a seed and handed to both sides.  Cache
operations must agree bit for bit (int8 codes, scales, tables, cursors).
The port's cache store has one page more than the reference's pool, a sink
that dropped writes land in; its pool views (``cache.k`` etc.) are compared
with the reference's arrays.  The K5 kernel itself runs only on a GPU
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.models import kv_cache as jkv

from repro_torch.kernels import ops, ref
from repro_torch.models import kv_cache as kv

L, HKV, DH = 2, 2, 8


def _np(x):
    return None if x is None else np.asarray(x)


def _assert_cache_equal(got: kv.PagedKVCache, want: jkv.PagedKVCache):
    for name in ("k", "v", "k_scale", "v_scale", "block_tables", "own_pages",
                 "lengths"):
        g, w = getattr(got, name), _np(getattr(want, name))
        if w is None:
            assert g is None, name
            continue
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        # bit for bit, float payloads included
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=name)


def _random_paged(rng, *, B, max_len, ps, n_pages, quantized):
    """The same random paged cache on both sides: payload, scales, tables
    with shuffled page ids and sentinel tails, and cursors."""
    jc = jkv.init_paged_cache(L, B, max_len, HKV, DH, page_size=ps,
                              n_pages=n_pages, quantized=quantized,
                              dtype=jnp.float32)
    pc = kv.init_paged_cache(L, B, max_len, HKV, DH, page_size=ps,
                             n_pages=n_pages, quantized=quantized,
                             dtype=torch.float32, device="cpu")
    shape = (L, n_pages, ps, HKV, DH)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:-1]).astype(np.float32)
        vs = rng.random(shape[:-1]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    maxP = max_len // ps
    perm = rng.permutation(n_pages)
    tables = np.full((B, maxP), n_pages, np.int32)
    used = 0
    for b in range(B):
        n = int(rng.integers(0, maxP + 1))
        n = min(n, n_pages - used)
        tables[b, :n] = perm[used:used + n]
        used += n
    lengths = rng.integers(0, max_len + 3, B).astype(np.int32)
    jc = jkv.PagedKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
        block_tables=jnp.asarray(tables), own_pages=jnp.asarray(tables),
        lengths=jnp.asarray(lengths))
    pc.k_store[:, :n_pages] = torch.from_numpy(k)
    pc.v_store[:, :n_pages] = torch.from_numpy(v)
    if quantized:
        pc.ks_store[:, :n_pages] = torch.from_numpy(ks)
        pc.vs_store[:, :n_pages] = torch.from_numpy(vs)
    pc = kv.PagedKVCache(k_store=pc.k_store, v_store=pc.v_store,
                         ks_store=pc.ks_store, vs_store=pc.vs_store,
                         block_tables=torch.from_numpy(tables.copy()),
                         own_pages=torch.from_numpy(tables.copy()),
                         lengths=torch.from_numpy(lengths))
    return pc, jc


# ---------------------------------------------------------------------------
# paged cache operations — bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
def test_init_paged_cache_equals_reference(quantized):
    got = kv.init_paged_cache(L, 3, 16, HKV, DH, page_size=4,
                              quantized=quantized, dtype=torch.float32,
                              device="cpu")
    want = jkv.init_paged_cache(L, 3, 16, HKV, DH, page_size=4,
                                quantized=quantized, dtype=jnp.float32)
    _assert_cache_equal(got, want)
    assert (got.n_pages, got.page_size, got.max_pages, got.capacity) == (
        want.n_pages, want.page_size, want.max_pages, want.capacity)
    # the reference's bytes plus the sink page
    sink = L * 4 * HKV * DH * got.k_store.element_size() * 2
    if quantized:
        sink += L * 4 * HKV * 4 * 2
    assert got.nbytes() == want.nbytes() + sink
    assert kv.pages_per_row(0, 4) == jkv.pages_per_row(0, 4) == 1
    assert kv.pages_per_row(9, 4) == jkv.pages_per_row(9, 4) == 3
    with pytest.raises(ValueError, match="multiple"):
        kv.init_paged_cache(L, 3, 18, HKV, DH, page_size=4, quantized=True)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_paged_equals_reference(quantized, T, seed):
    """Cursors inside a reservation, at a sentinel slot and past capacity
    (those writes drop), on a pool with shuffled page ids."""
    rng = np.random.default_rng(seed)
    B, max_len, ps, P = 6, 16, 4, 14
    pc, jc = _random_paged(rng, B=B, max_len=max_len, ps=ps, n_pages=P,
                           quantized=quantized)
    k_new = rng.standard_normal((B, T, HKV, DH)).astype(np.float32)
    v_new = rng.standard_normal((B, T, HKV, DH)).astype(np.float32)
    # jitted, as the engine runs it (the scale is amax · float32(1/127))
    jfn = jax.jit(jkv.append_token_paged if T == 1
                  else jkv.append_tokens_paged)
    pfn = kv.append_token_paged if T == 1 else kv.append_tokens_paged
    for i in range(L):
        jk, jv, jks, jvs = jfn(
            jc.k[i], jc.v[i], None if jc.k_scale is None else jc.k_scale[i],
            None if jc.v_scale is None else jc.v_scale[i], jc.block_tables,
            jnp.asarray(k_new), jnp.asarray(v_new), jc.lengths)
        pfn(pc.k_store[i], pc.v_store[i],
            None if pc.ks_store is None else pc.ks_store[i],
            None if pc.vs_store is None else pc.vs_store[i], pc.block_tables,
            torch.from_numpy(k_new), torch.from_numpy(v_new), pc.lengths)
        np.testing.assert_array_equal(pc.k[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pc.v[i].numpy(), np.asarray(jv))
        if quantized:
            np.testing.assert_array_equal(pc.k_scale[i].numpy(),
                                          np.asarray(jks))
            np.testing.assert_array_equal(pc.v_scale[i].numpy(),
                                          np.asarray(jvs))


@pytest.mark.parametrize("quantized", [True, False])
def test_dropped_write_never_overwrites_a_live_one(quantized):
    """Row 0 owns the last page P-1 and writes offset 2 of it.  Row 1 has
    an all-sentinel table and row 2 a cursor past capacity, both at offset
    2: clamped into the pool, their writes would land on (P-1, 2) too.
    Row 0's value must survive, as in the reference."""
    B, max_len, ps, P = 3, 8, 4, 5
    pc = kv.init_paged_cache(1, B, max_len, HKV, DH, page_size=ps, n_pages=P,
                             quantized=quantized, dtype=torch.float32,
                             device="cpu")
    jc = jkv.init_paged_cache(1, B, max_len, HKV, DH, page_size=ps,
                              n_pages=P, quantized=quantized,
                              dtype=jnp.float32)
    tables = np.array([[P - 1, P], [P, P], [0, 1]], np.int32)
    lengths = np.array([2, 2, max_len + 2], np.int32)
    rng = np.random.default_rng(5)
    k_new = rng.standard_normal((B, 1, HKV, DH)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, HKV, DH)).astype(np.float32)
    jk, *_ = jkv.append_token_paged(
        jc.k[0], jc.v[0], None if jc.k_scale is None else jc.k_scale[0],
        None if jc.v_scale is None else jc.v_scale[0], jnp.asarray(tables),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(lengths))
    kv.append_token_paged(
        pc.k_store[0], pc.v_store[0],
        None if pc.ks_store is None else pc.ks_store[0],
        None if pc.vs_store is None else pc.vs_store[0],
        torch.from_numpy(tables), torch.from_numpy(k_new),
        torch.from_numpy(v_new), torch.from_numpy(lengths))
    np.testing.assert_array_equal(pc.k[0].numpy(), np.asarray(jk))
    live = kv.quantize_kv(torch.from_numpy(k_new[0, 0]))[0] if quantized \
        else torch.from_numpy(k_new[0, 0])
    assert torch.equal(pc.k[0, P - 1, 2], live)
    # nothing else in the pool moved: only (P-1, 2) differs from zero
    touched = pc.k[0].reshape(P * ps, -1).abs().sum(dim=-1).nonzero()
    assert touched.flatten().tolist() == [(P - 1) * ps + 2]


def test_linearize_pages_equals_reference():
    rng = np.random.default_rng(3)
    pc, jc = _random_paged(rng, B=5, max_len=12, ps=4, n_pages=9,
                           quantized=True)
    for i in range(L):
        got = kv.linearize_pages(pc.k[i], pc.block_tables)
        want = jkv.linearize_pages(jc.k[i], jc.block_tables)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = kv.linearize_pages(pc.v_scale[i], pc.block_tables)
        want = jkv.linearize_pages(jc.v_scale[i], jc.block_tables)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantized", [True, False])
def test_table_operations_equal_reference(quantized):
    """assign_pages / free_slots_paged / free_inactive_paged, with
    out-of-range padding rows (dropped) in the host row lists."""
    rng = np.random.default_rng(7)
    B, max_len, ps, P = 6, 16, 4, 20
    pc, jc = _random_paged(rng, B=B, max_len=max_len, ps=ps, n_pages=P,
                           quantized=quantized)
    rows = np.array([4, 1, B, B], np.int32)           # two padding rows
    pages = np.full((4, max_len // ps), P, np.int32)
    pages[0, :3] = [7, 2, 11]
    pages[1, :1] = [19]
    pages[2:, :2] = [5, 6]                            # padding: dropped
    pc = kv.assign_pages(pc, rows, pages)
    jc = jkv.assign_pages(jc, jnp.asarray(rows), jnp.asarray(pages))
    _assert_cache_equal(pc, jc)
    slots = np.array([2, B], np.int32)
    pc = kv.free_slots_paged(pc, slots)
    jc = jkv.free_slots_paged(jc, jnp.asarray(slots))
    _assert_cache_equal(pc, jc)
    live = np.array([True, False, True, True, False, True])
    pc = kv.free_inactive_paged(pc, torch.from_numpy(live))
    jc = jkv.free_inactive_paged(jc, jnp.asarray(live))
    _assert_cache_equal(pc, jc)


@pytest.mark.parametrize("quantized", [True, False])
def test_insert_rows_paged_equals_reference(quantized):
    """A contiguous side batch of width 4 (one padding row) cut into page
    reservations, with sentinel tails that drop their chunks."""
    rng = np.random.default_rng(11)
    B, max_len, ps, P = 5, 16, 4, 18
    pc, jc = _random_paged(rng, B=B, max_len=max_len, ps=ps, n_pages=P,
                           quantized=quantized)
    W = 4
    jsub = jkv.init_cache(L, W, max_len, HKV, DH, quantized=quantized,
                          dtype=jnp.float32)
    shape = (L, W, max_len, HKV, DH)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:-1]).astype(np.float32)
        vs = rng.random(shape[:-1]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    lengths = np.array([3, 9, 16, 5], np.int32)
    jsub = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                       k_scale=None if ks is None else jnp.asarray(ks),
                       v_scale=None if vs is None else jnp.asarray(vs),
                       lengths=jnp.asarray(lengths))
    t = lambda a: None if a is None else torch.from_numpy(a)
    psub = kv.KVCache(k=t(k), v=t(v), k_scale=t(ks), v_scale=t(vs),
                      lengths=t(lengths))
    slots = np.array([3, 0, 1, B], np.int32)
    pages = np.full((W, max_len // ps), P, np.int32)
    pages[0, :1] = [4]
    pages[1, :3] = [0, 17, 9]
    pages[2, :4] = [1, 2, 3, 5]
    pages[3, :2] = [6, 7]
    pc = kv.insert_rows_paged(pc, psub, slots, pages)
    jc = jkv.insert_rows_paged(jc, jsub, jnp.asarray(slots),
                               jnp.asarray(pages))
    _assert_cache_equal(pc, jc)


@pytest.mark.parametrize("quantized", [True, False])
def test_contiguous_slot_operations_equal_reference(quantized):
    """insert_at_slots / free_slots / free_inactive / with_lengths /
    group_rows on the contiguous cache."""
    rng = np.random.default_rng(13)
    B, W, S = 5, 2, 8
    shape = (L, B, S, HKV, DH)

    def make(batch):
        sh = (L, batch, S, HKV, DH)
        if quantized:
            arrs = (rng.integers(-127, 128, sh).astype(np.int8),
                    rng.integers(-127, 128, sh).astype(np.int8),
                    rng.random(sh[:-1]).astype(np.float32),
                    rng.random(sh[:-1]).astype(np.float32))
        else:
            arrs = (rng.standard_normal(sh).astype(np.float32),
                    rng.standard_normal(sh).astype(np.float32), None, None)
        lengths = rng.integers(0, S, batch).astype(np.int32)
        j = jkv.KVCache(*[None if a is None else jnp.asarray(a)
                          for a in arrs], lengths=jnp.asarray(lengths))
        p = kv.KVCache(*[None if a is None else torch.from_numpy(a.copy())
                         for a in arrs], lengths=torch.from_numpy(lengths))
        return p, j

    assert shape[1] == B
    pc, jc = make(B)
    psub, jsub = make(W + 1)
    slots = np.array([3, 0, B], np.int32)              # one padding row

    def check(p, j):
        for name in ("k", "v", "k_scale", "v_scale", "lengths"):
            g, w = getattr(p, name), _np(getattr(j, name))
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    pc = kv.insert_at_slots(pc, psub, slots)
    jc = jkv.insert_at_slots(jc, jsub, jnp.asarray(slots))
    check(pc, jc)
    pc = kv.free_slots(pc, np.array([1, B + 2], np.int32))
    jc = jkv.free_slots(jc, jnp.asarray(np.array([1, B + 2], np.int32)))
    check(pc, jc)
    live = np.array([True, False, True, False, True])
    pc = kv.free_inactive(pc, torch.from_numpy(live))
    jc = jkv.free_inactive(jc, jnp.asarray(live))
    check(pc, jc)
    new = np.arange(B, dtype=np.int32)
    check(kv.with_lengths(pc, torch.from_numpy(new)),
          jkv.with_lengths(jc, jnp.asarray(new)))
    base = np.array([0, 4, 8], np.int32)
    np.testing.assert_array_equal(kv.group_rows(base, 4),
                                  np.asarray(jkv.group_rows(base, 4)))


# ---------------------------------------------------------------------------
# PageAllocator — the same page ids and counters as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_allocator_matches_reference(seed):
    rng = np.random.default_rng(seed)
    got, want = kv.PageAllocator(24, 4), jkv.PageAllocator(24, 4)
    held = []
    for _ in range(200):
        op = rng.integers(0, 5)
        if op <= 1:
            n = int(rng.integers(0, 9))
            a, b = got.alloc(n), want.alloc(n)
            assert a == b
            if a:
                held.append(a)
        elif op == 2 and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            got.release(pages)
            want.release(pages)
        elif op == 3:
            n = int(rng.integers(0, 30))
            assert got.reserve(n) == want.reserve(n)
            if want.reserved and rng.random() < 0.5:
                m = int(rng.integers(0, want.reserved + 1))
                got.unreserve(m)
                want.unreserve(m)
        elif held:
            pages = held[int(rng.integers(0, len(held)))]
            got.retain(pages)
            want.retain(pages)
            held.append(list(pages))
        assert (got.n_free, got.in_use, got.hwm, got.free_lwm, got.reserved,
                got.fragmentation) == (want.n_free, want.in_use, want.hwm,
                                       want.free_lwm, want.reserved,
                                       want.fragmentation)
        assert [got.refcount(p) for p in range(24)] == \
            [want.refcount(p) for p in range(24)]
    for pages in held:
        got.release(pages)
    assert got.in_use == 0 and got.n_free == 24


def test_page_allocator_errors_are_atomic():
    a = kv.PageAllocator(4, 2)
    pages = a.alloc(2)
    with pytest.raises(ValueError, match="double free"):
        a.release([pages[0], pages[0]])
    assert a.in_use == 2                      # nothing was released
    with pytest.raises(ValueError, match="outside pool"):
        a.release([7])
    with pytest.raises(ValueError, match="unallocated"):
        a.retain([3])
    assert a.alloc(3) is None and a.n_free == 2


# ---------------------------------------------------------------------------
# K5's plain version against the reference's Pallas kernel and plain one
# ---------------------------------------------------------------------------

def _paged_attention_inputs(rng, *, B, H, HKV_, dh, ps, maxP, P):
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.integers(-127, 128, (P, ps, HKV_, dh)).astype(np.int8)
    v = rng.integers(-127, 128, (P, ps, HKV_, dh)).astype(np.int8)
    ks = (rng.random((P, ps, HKV_)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((P, ps, HKV_)) * 0.02 + 1e-3).astype(np.float32)
    perm = rng.permutation(P)
    tables = np.full((B, maxP), P, np.int32)           # sentinel tails
    lengths = np.zeros((B,), np.int32)
    used = 0
    for b in range(B):
        n = int(rng.integers(1, maxP + 1))
        tables[b, :n] = perm[used:used + n]
        used += n
        lengths[b] = int(rng.integers(1, n * ps + 1))
    lengths[0] = tables[0].tolist().index(P) * ps if P in tables[0] \
        else maxP * ps                                 # a full reservation
    return q, k, ks, v, vs, tables, lengths


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("H,HKV_", [(4, 4), (4, 2)])
def test_decode_attention_paged_matches(impl, ps, H, HKV_):
    """f32 within 1e-5 (the Pallas kernel's online softmax reorders the
    sums); ps = 4 runs the reference's multi-page variant."""
    rng = np.random.default_rng(ps * 10 + H + HKV_)
    B, dh, maxP = 5, 16, 5
    args = _paged_attention_inputs(rng, B=B, H=H, HKV_=HKV_, dh=dh, ps=ps,
                                   maxP=maxP, P=B * maxP)
    sm = 1.0 / np.sqrt(dh)
    got = ops.decode_attention_paged(*map(torch.from_numpy, args),
                                     sm_scale=sm)
    want = jops.decode_attention_paged(*map(jnp.asarray, args), sm_scale=sm,
                                       impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_decode_attention_paged_bf16_within_one_ulp(impl):
    rng = np.random.default_rng(21)
    args = list(_paged_attention_inputs(rng, B=4, H=4, HKV_=2, dh=16, ps=4,
                                        maxP=6, P=24))
    q32 = args[0]
    args[0] = torch.from_numpy(q32).to(torch.bfloat16)
    got = ops.decode_attention_paged(
        args[0], *map(torch.from_numpy, args[1:]), sm_scale=0.25).float()
    jq = jnp.asarray(args[0].float().numpy()).astype(jnp.bfloat16)
    want = jops.decode_attention_paged(jq, *map(jnp.asarray, args[1:]),
                                       sm_scale=0.25, impl=impl)
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 ulp: 2^-7 relative to the larger magnitude
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7, atol=1e-6)


def test_paged_plain_equals_contiguous_plain_on_linearized_cache():
    rng = np.random.default_rng(4)
    q, k, ks, v, vs, tables, lengths = map(
        torch.from_numpy, _paged_attention_inputs(rng, B=4, H=4, HKV_=2,
                                                  dh=16, ps=4, maxP=5, P=20))
    got = ref.ref_decode_attention_paged(q, k, ks, v, vs, tables, lengths,
                                         0.25)
    lin = lambda a: kv.linearize_pages(a, tables)
    want = ref.ref_decode_attention(q, lin(k), lin(ks), lin(v), lin(vs),
                                    lengths, 0.25)
    assert torch.equal(got, want)


def test_decode_attention_paged_dispatch_on_cpu():
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a) for a in _paged_attention_inputs(
        rng, B=2, H=4, HKV_=4, dh=8, ps=4, maxP=2, P=4)]
    ops.reset_launch_counts()
    a = ops.decode_attention_paged(*args, sm_scale=0.3, impl="auto")
    b = ops.decode_attention_paged(*args, sm_scale=0.3, impl="torch")
    assert torch.equal(a, b)
    assert ops.launch_counts()["decode_attention_paged"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention_paged(*args, sm_scale=0.3, impl="cuda")
