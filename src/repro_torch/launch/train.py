"""Training launcher: ``--arch <id>`` selects any architecture.

Runs the training loop (``repro_torch.train.loop``) on the card, or on the
CPU with ``--device cpu``.  The architecture's reduced config is used
unless ``--full`` is given (the full config needs the card's memory).

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 50 --batch 4 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "const"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (needs the card's memory)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir, seed=args.seed)
    oc = AdamWConfig(lr=args.lr, schedule=args.schedule,
                     warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed)
    trainer = Trainer(cfg, tc, oc, dc, device=args.device)
    print(f"[train] arch={args.arch} reduced={not args.full} "
          f"device={trainer.device} start_step={trainer.step}")
    last = trainer.run()
    first_loss = trainer.metrics_log[0]["loss"] if trainer.metrics_log else 0
    print(f"[train] done: step={trainer.step} "
          f"loss {first_loss:.4f} -> {last.get('loss', 0):.4f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(trainer.metrics_log, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
