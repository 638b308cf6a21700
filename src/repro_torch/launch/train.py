"""Training driver:
``python -m repro_torch.launch.train --arch transformer-base --steps 100``.

Port of ``repro/launch/train.py``.  Trains the REDUCED config of
``--arch`` end to end on ``--device`` (``cuda`` unless the caller asks for
the CPU), from random weights (``torch.Generator`` seed 0), with the
substrate of a long job: the checkpointed loop, the step watchdog, the
restart wrapper and the resumable data iterator.  An encoder-decoder arch
trains on ``TranslationBatches`` over the synthetic corpus, a decoder-only
one on ``LMBatches``.  With ``--ckpt-dir`` a second run with more
``--steps`` resumes from the last checkpoint.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import LMBatches, TranslationBatches, make_corpus
from repro_torch.distributed.fault import StepWatchdog, run_with_restarts
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import make_train_step, train_loop


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="transformer-base")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the step")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps))
    opt_state = opt.init(params)
    step = make_train_step(model, opt, accum_steps=args.accum)

    if cfg.enc_dec:
        corpus = make_corpus(800, cfg.vocab, seed=0)
        data = TranslationBatches(corpus, args.batch_size,
                                  sort_mode="tokens")
    else:
        data = LMBatches(cfg.vocab, args.batch_size, args.seq_len)

    ck = Checkpointer(args.ckpt_dir, keep=2) if args.ckpt_dir else None

    def job():
        out = train_loop(train_step=step, params=params,
                         opt_state=opt_state, batches=data,
                         steps=args.steps, checkpointer=ck,
                         save_every=args.save_every,
                         watchdog=StepWatchdog())
        hist = out["history"]
        if not hist:
            print(f"final loss: none (already at step {args.steps})")
        else:
            print(f"final loss: {hist[-1]['loss']:.4f} "
                  f"(first logged: {hist[0]['loss']:.4f})")
        print("watchdog:", out["watchdog"])

    run_with_restarts(job, max_restarts=args.max_restarts)


if __name__ == "__main__":
    main(sys.argv[1:])
