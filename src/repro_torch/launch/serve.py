"""Serving launcher: batched prefill + decode, as the JAX package's
``launch/serve.py`` runs it, step for step.

A fixed-slot batched decoder: requests are taken in waves of ``slots``;
each request's prompt is fed token by token through ``decode_step`` into
its slot (prefill), then the wave steps together through greedy decoding.
The batched prefill forward (``model_api.forward(...,
logits_last_only=True)``) is not on this loop, as in the reference.  Decode
runs eagerly.  Every family is served through ``model_api``; an
encoder-decoder model decodes against its zero-initialised cross cache, as
in the reference (no frames frontend).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --requests 8 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model_api


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (L,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchServer:
    """Fixed-slot batched decoder (continuous batching).  ``model`` is a
    model of ``cfg`` to serve (e.g. carried over with
    ``convert.params_from_jax``); without one, parameters are made from
    ``seed`` on ``device``."""

    def __init__(self, cfg: ArchConfig, *, slots: int = 4,
                 max_seq: int = 256, seed: int = 0,
                 model: Optional[nn.Module] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if model is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            model = model_api.init_params(cfg, gen, self.device)
        self.params = model
        self.cache = model_api.init_cache(cfg, slots, max_seq,
                                          dtype=torch.float32,
                                          device=self.device)
        self.pos = 0
        self.active: List[Optional[Request]] = [None] * slots
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "completed": 0}

    def _decode(self, tokens: torch.Tensor, pos: int) -> torch.Tensor:
        logits, self.cache = model_api.decode_step(self.params, self.cfg,
                                                   self.cache, tokens, pos)
        return logits

    # Prefill is per-request teacher-forced through decode steps: the other
    # slots step on token 0 at the same positions, as in the reference.
    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        for i, t in enumerate(req.prompt):
            tok = torch.zeros((self.slots, 1), dtype=torch.int64,
                              device=self.device)
            tok[slot, 0] = int(t)
            self._decode(tok, self.pos + i)
        self.stats["prefill_tokens"] += len(req.prompt)

    def submit_all(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Run all requests to completion (greedy)."""
        queue = list(requests)
        results: Dict[int, List[int]] = {}
        # All slots share one position counter, so requests run in waves of
        # `slots`.
        while queue:
            wave = [queue.pop(0) for _ in range(min(self.slots, len(queue)))]
            self.cache = model_api.init_cache(self.cfg, self.slots,
                                              self.max_seq,
                                              dtype=torch.float32,
                                              device=self.device)
            self.pos = 0
            maxp = max(len(r.prompt) for r in wave)
            for i, r in enumerate(wave):
                self._prefill_into_slot(i, r)
            # as in the reference, the last prompt token is fed again at
            # pos = maxp
            self.pos = maxp
            gen = max(r.max_new for r in wave)
            last = torch.tensor([[int(r.prompt[-1])] for r in wave]
                                + [[0]] * (self.slots - len(wave)),
                                dtype=torch.int64, device=self.device)
            for _ in range(gen):
                logits = self._decode(last, self.pos)
                nxt = torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1)
                last = nxt[:, None]
                self.pos += 1
                self.stats["decode_steps"] += 1
                nxt = nxt.tolist()
                for i, r in enumerate(wave):
                    if len(r.out) < r.max_new:
                        r.out.append(nxt[i])
            for r in wave:
                r.done = True
                results[r.rid] = r.out
                self.stats["completed"] += 1
        return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if cfg.is_encdec:
        print("[serve] enc-dec serving needs a frames frontend; the decoder "
              "path is exercised via tests/dry-run")
    rng = np.random.default_rng(args.seed)
    server = BatchServer(cfg, slots=args.slots,
                         max_seq=args.prompt_len + args.gen + 1,
                         seed=args.seed, device=args.device)
    reqs = [Request(i, rng.integers(0, cfg.vocab, args.prompt_len,
                                    dtype=np.int64).astype(np.int32),
                    args.gen)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = server.submit_all(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    print(f"[serve] {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s) on {server.device}; stats={server.stats}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
