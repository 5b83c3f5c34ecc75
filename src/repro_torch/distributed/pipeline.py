"""Pipeline parallelism (GPipe) over a ``stage`` mesh axis, as the JAX
package's ``distributed/pipeline.py`` schedules it, over
``torch.distributed``.

Layers are split into S contiguous stages (:func:`stage_split`); each
stage's parameters live on one ``stage`` rank, and micro-batches stream
through ``n_micro + S - 1`` ticks: at tick t stage s runs micro-batch
``t - s``, then every stage passes its activation to the next one around
the ring (the reference's ``ppermute(i -> i+1)``; point-to-point sends,
none at S = 1).  The last stage's outputs are broadcast to every stage by
an all-reduce, whose gradient is the replicated cotangent itself (the
transpose of the reference's ``psum`` of a masked value).

The reference's SPMD program computes junk on idle ticks and masks it;
here a stage skips its idle ticks (sending zeros), which changes neither
outputs nor gradients.  The backward pass is the reverse schedule, run
explicitly by :class:`_GPipe`: per tick in reverse order every stage
sends the gradient of what it received back to the previous stage, then
recomputes its stage on the saved input and differentiates it.  Every
stage takes part in every exchange, so no rank waits on a send that
autograd never ran.

``stage_fn(stage_params, x, sidx)`` is any per-stage function that keeps
the activation's shape.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.distributed.sharding import axis_sizes


def stage_split(n_layers: int, n_stages: int) -> list:
    """Contiguous layer ranges per stage (uneven remainders go to the
    later stages, so stage 0, which also holds the embedding in typical
    use, is lightest)."""
    base = n_layers // n_stages
    extra = n_layers % n_stages
    out = []
    lo = 0
    for s in range(n_stages):
        hi = lo + base + (1 if s >= n_stages - extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble: (S-1) / (n_micro + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Ring permute over ``group``: send ``x`` to rank ``s + step`` and
    return what rank ``s - step`` sent (the identity at one rank)."""
    S = dist.get_world_size(group)
    if S == 1:
        return x
    s = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (s + step) % S), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (s - step) % S), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _GPipe(torch.autograd.Function):
    """The pipelined apply of one stage rank: forward and backward
    schedules (see the module docstring)."""

    @staticmethod
    def forward(ctx, stage_fn, spec, group, x, *leaves):
        S = dist.get_world_size(group)
        s = dist.get_rank(group)
        nm = x.shape[0]
        params = tree_unflatten(list(leaves), spec)
        inflight = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        saved = {}
        for t in range(nm + S - 1):
            m = t - s
            if 0 <= m < nm:
                z_in = x[m] if s == 0 else inflight
                saved[t] = z_in
                z = stage_fn(params, z_in, s)
                if s == S - 1:
                    outputs[m] = z
            else:
                z = torch.zeros_like(inflight)
            inflight = _shift(z, group, 1)
        if S > 1:
            if s != S - 1:
                outputs.zero_()
            dist.all_reduce(outputs, group=group)
        ctx.stage_fn, ctx.spec, ctx.group = stage_fn, spec, group
        ctx.saved = saved
        ctx.nm = nm
        ctx.save_for_backward(*leaves)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        group, nm = ctx.group, ctx.nm
        S = dist.get_world_size(group)
        s = dist.get_rank(group)
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        params = tree_unflatten(leaves, ctx.spec)
        wrt = [t for t in leaves if t.requires_grad]
        g_params = [torch.zeros_like(t) for t in wrt]
        g_x = torch.zeros_like(g_out) if s == 0 else None
        g_send = torch.zeros_like(g_out[0])
        for t in reversed(range(nm + S - 1)):
            g_z = _shift(g_send, group, -1) if S > 1 \
                else torch.zeros_like(g_send)
            m = t - s
            g_send = torch.zeros_like(g_send)
            if not 0 <= m < nm:
                continue
            if s == S - 1:
                g_z = g_z + g_out[m]
            z_in = ctx.saved[t].detach().requires_grad_(True)
            with torch.enable_grad():
                z = ctx.stage_fn(params, z_in, s)
                grads = torch.autograd.grad(z, [z_in] + wrt, g_z,
                                            allow_unused=True)
            for acc, g in zip(g_params, grads[1:]):
                if g is not None:
                    acc.add_(g)
            if s == 0:
                g_x[m] = grads[0]
            else:
                g_send = grads[0]
        it = iter(g_params)
        return (None, None, None, g_x,
                *(next(it) if t.requires_grad else None for t in leaves))


def make_pipelined_apply(stage_fn: Callable, mesh, *,
                         stage_axis: str = "stage",
                         n_micro: int | None = None):
    """Build ``apply(stage_params, x) -> y`` running ``stage_fn`` as a
    GPipe pipeline over ``stage_axis``.

    ``stage_params``: a pytree with a leading stage axis on every leaf
    (each stage rank uses its own slice).  ``x``: (n_micro, mb, ...)
    micro-batched input, the same on every stage rank.  Returns y with the
    same leading (n_micro, mb) layout, the same on every stage rank;
    gradients reach ``x`` on stage 0 and each stage's slice of the
    parameters on its own rank."""
    S = axis_sizes(mesh)[stage_axis]
    group = mesh.get_group(stage_axis)
    sidx = mesh.get_local_rank(stage_axis)

    def apply(stage_params, x):
        nm = x.shape[0] if n_micro is None else n_micro
        assert x.shape[0] == nm
        assert dist.get_world_size(group) == S
        local = tree_map(lambda p: p[sidx], stage_params)
        leaves, spec = tree_flatten(local)
        return _GPipe.apply(stage_fn, spec, group, x, *leaves)

    return apply
