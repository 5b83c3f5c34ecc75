"""The training loop: the train step, checkpoint/restart, straggler watch,
as the JAX package's ``train/loop.py`` runs them.

``Trainer`` drives any architecture end to end:

* the step is one plain function (loss -> backward -> clip -> AdamW); the
  optimizer updates the parameters and its moments in place, so the step
  needs no second copy of either;
* checkpoints every ``ckpt_every`` steps through ``io.checkpoint`` (two-phase
  commit, the reference's format and keys); on construction it restores the
  newest sealed checkpoint and replays the data stream to the exact
  position;
* non-finite-loss rollback: ``nan_patience`` consecutive bad steps trigger
  a restore from the last sealed checkpoint (the silent-corruption regime
  of ``distributed.fault``);
* per-step wall time feeds the ``StragglerDetector``.

The trainer runs on the card unless it is given ``device="cpu"``; its
parameters come from a ``torch.Generator`` on that device seeded with
``seed``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import load_tree, named_to_tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.fault import StragglerDetector
from repro_torch.io import checkpoint as ckpt
from repro_torch.models import model_api
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         init_opt_state, opt_state_shapes)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    remat: bool = True
    nan_patience: int = 3
    param_dtype: str = "float32"


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    remat: bool = True):
    """The (model, opt_state, batch) -> (model, opt_state, metrics) step.
    The model's parameters must require grad; they and the optimizer's
    moments are updated in place.  A parameter the loss does not reach
    gets a zero gradient, as under ``jax.grad``."""

    def step(model: nn.Module, opt_state: OptState, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, metrics = model_api.loss_fn(model, cfg, batch, remat=remat)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        _, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        del grads
        metrics = {k: v.detach() for k, v in dict(metrics,
                                                   **opt_metrics).items()}
        return model, opt_state, metrics

    return step


class Trainer:
    def __init__(self, arch_cfg: ArchConfig, train_cfg: TrainConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 device: DeviceLike = None):
        self.cfg = arch_cfg
        self.tc = train_cfg
        self.device = resolve_device(device)
        self.oc = opt_cfg or AdamWConfig(total_steps=train_cfg.steps)
        self.dc = data_cfg or DataConfig(vocab=arch_cfg.vocab, seq_len=128,
                                         global_batch=4, seed=train_cfg.seed)
        self.data = TokenStream(self.dc)
        self.detector = StragglerDetector()
        self.step_fn = make_train_step(arch_cfg, self.oc,
                                       remat=train_cfg.remat)
        self.rng = np.random.default_rng(train_cfg.seed)

        dtype = getattr(torch, train_cfg.param_dtype)
        gen = torch.Generator(self.device).manual_seed(train_cfg.seed)
        self.model = model_api.init_params(arch_cfg, gen, self.device,
                                           dtype=dtype)
        self.model.requires_grad_(True)
        # the model's parameters by name: the optimizer's keys
        self.params = dict(self.model.named_parameters())
        self.opt_state = init_opt_state(self.params)
        self.step = 0
        self._bad_steps = 0
        self.metrics_log: list = []
        self._maybe_restore()

    # -- checkpoint/restart --------------------------------------------------
    def _maybe_restore(self) -> bool:
        if not self.tc.ckpt_dir:
            return False
        path = ckpt.latest_complete(self.tc.ckpt_dir)
        if path is None:
            return False
        shapes = model_api.param_shapes(self.cfg)
        state, manifest = ckpt.restore(
            path, {"params": shapes, "opt": opt_state_shapes(shapes)})
        load_tree(self.params, state["params"])
        opt = state["opt"]
        load_tree(self.opt_state.mu, opt.mu)
        load_tree(self.opt_state.nu, opt.nu)
        self.opt_state = OptState(
            torch.as_tensor(opt.step, dtype=torch.int32).to(self.device),
            self.opt_state.mu, self.opt_state.nu)
        self.step = int(manifest["step"])
        self.data.load_state_dict(manifest["extra"]["data_state"])
        return True

    def _save(self) -> None:
        if not self.tc.ckpt_dir:
            return
        opt = self.opt_state
        ckpt.save(self.tc.ckpt_dir, self.step,
                  {"params": named_to_tree(self.cfg, self.params),
                   "opt": OptState(opt.step,
                                   named_to_tree(self.cfg, opt.mu),
                                   named_to_tree(self.cfg, opt.nu))},
                  extra={"data_state": self.data.state_dict()})
        ckpt.prune(self.tc.ckpt_dir, self.tc.ckpt_keep)

    # -- the loop ------------------------------------------------------------
    def _batch_for(self, raw: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in raw.items()}
        B = raw["tokens"].shape[0]
        if self.cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(self.rng.standard_normal(
                (B, self.cfg.n_patches, self.cfg.d_model)).astype(
                    np.float32)).to(self.device)
        if self.cfg.is_encdec:
            batch["frames"] = torch.from_numpy(self.rng.standard_normal(
                (B, self.cfg.enc_frames, self.cfg.d_model)).astype(
                    np.float32)).to(self.device)
        return batch

    def run(self, steps: Optional[int] = None) -> Dict[str, float]:
        target = self.step + (steps if steps is not None else self.tc.steps)
        last: Dict[str, float] = {}
        while self.step < target:
            raw = next(self.data)
            batch = self._batch_for(raw)
            t0 = time.perf_counter()
            self.model, self.opt_state, metrics = self.step_fn(
                self.model, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            status = self.detector.observe(dt)

            if not np.isfinite(loss):
                self._bad_steps += 1
                if self._bad_steps >= self.tc.nan_patience:
                    restored = self._maybe_restore()
                    self._bad_steps = 0
                    if not restored:
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}, "
                            "no checkpoint to roll back to")
                    continue
            else:
                self._bad_steps = 0

            self.step += 1
            last = {k: float(v) for k, v in metrics.items()}
            last.update(step_time=dt, straggler=status["straggler"])
            self.metrics_log.append({"step": self.step, **last})
            if self.tc.ckpt_dir and self.step % self.tc.ckpt_every == 0:
                self._save()
        if self.tc.ckpt_dir:
            self._save()
        return last
