"""Optimizer: AdamW with global-norm clipping and WSD / cosine schedules,
as the JAX package's ``train/optimizer.py`` computes them.

Parameters, gradients and the two moments are dicts of tensors keyed by
the model's parameter names (``model.named_parameters()``).  The
reference builds new moment trees each step; here the moments and the
parameters are updated in place (``torch._foreach_*`` and per-tensor
``mul_``/``add_``), so that a model whose parameters, gradients and
moments fill most of the card needs no second copy of its moments.  The
arithmetic is float32 throughout, in the reference's order: ``b1 **
step`` with the int32 step cast to float32, the clip scale ``min(1,
max_norm / max(norm, 1e-9))``.

Weight decay skips the parameters whose key path in the reference's
parameter tree (``['layers']['ln1']`` for the port's ``layers.3.ln1``)
holds one of ``_DECAY_EXEMPT``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.model_api import TensorSpec
from repro_torch.models.params import ref_keystr


class OptState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    mu: dict               # first moment, float32, like params
    nu: dict               # second moment, float32, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "wsd"          # "wsd" | "cosine" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1        # WSD: fraction of steps in final decay


def schedule_fn(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """LR schedule of a float32 step.  "wsd" is MiniCPM's
    warmup-stable-decay: linear warmup, long constant plateau, short linear
    decay to 10%."""
    w, T = cfg.warmup_steps, cfg.total_steps

    def f32(step):
        return torch.as_tensor(step, dtype=torch.float32)

    def wsd(step):
        step = f32(step)
        warm = step / max(w, 1)
        decay_steps = max(int(T * cfg.decay_frac), 1)
        decay_start = T - decay_steps
        dec = 1.0 - 0.9 * (step - decay_start) / decay_steps
        return cfg.lr * torch.clamp(torch.minimum(warm, dec), 0.0, 1.0)

    def cosine(step):
        step = f32(step)
        warm = step / max(w, 1)
        prog = torch.clamp((step - w) / max(T - w, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return cfg.lr * torch.minimum(warm, 0.1 + 0.9 * cos)

    def const(step):
        return cfg.lr * torch.clamp(f32(step) / max(w, 1), 0.0, 1.0)

    return {"wsd": wsd, "cosine": cosine, "const": const}[cfg.schedule]


def init_opt_state(params: Dict[str, torch.Tensor]) -> OptState:
    """Zero moments (float32) like ``params`` and step 0, on the
    parameters' device."""
    device = next(iter(params.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})


def opt_state_shapes(param_tree) -> OptState:
    """Abstract optimizer state matching an abstract parameter tree (the
    reference's stacked tree of :class:`TensorSpec`)."""
    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        return TensorSpec(tuple(node.shape), torch.float32)
    return OptState(step=TensorSpec((), torch.int32), mu=f32(param_tree),
                    nu=f32(param_tree))


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``tensors`` together, in float32."""
    norms = torch._foreach_norm([x.float() for x in tensors.values()])
    return torch.sqrt(torch.stack(norms).square().sum())


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` (float32) in place so that their global norm is at
    most ``max_norm``; returns them and the norm before scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(list(grads.values()), scale)
    return grads, norm


_DECAY_EXEMPT = ("norm", "ln", "bias", "dt_bias", "A_log")


def _decays(path: str) -> bool:
    return not any(tag in path for tag in _DECAY_EXEMPT)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: OptState
                 ) -> Tuple[Dict[str, torch.Tensor], OptState,
                            Dict[str, torch.Tensor]]:
    """One AdamW step on ``params`` (any float dtype; the math is float32
    and the result is cast back).  ``params`` and the moments of ``state``
    are updated in place, and ``grads`` are used as scratch (float32
    gradients are clipped in place).  Returns the parameters, the state
    with its step advanced, and ``{"grad_norm", "lr"}``."""
    names = list(params)
    g32 = {k: grads[k].float() for k in names}
    g32, gnorm = clip_by_global_norm(g32, cfg.clip_norm)
    step = state.step + 1
    stepf = step.float()
    lr = schedule_fn(cfg)(stepf)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    gs = [g32[k] for k in names]
    mus = [state.mu[k] for k in names]
    nus = [state.nu[k] for k in names]
    torch._foreach_mul_(mus, cfg.b1)
    torch._foreach_add_(mus, gs, alpha=1 - cfg.b1)
    torch._foreach_mul_(nus, cfg.b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - cfg.b2)
    del gs, g32

    for k, m, v in zip(names, mus, nus):
        p = params[k]
        upd = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        p32 = p.float()
        if _decays(ref_keystr(k)):
            upd.add_(p32 * cfg.weight_decay)
        upd.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p32.sub_(upd))
    return params, OptState(step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": lr}
