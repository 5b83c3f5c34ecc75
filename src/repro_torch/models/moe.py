"""Mixture-of-experts block with capacity-gather dispatch, as the JAX
package's ``models/moe.py`` computes it.

Tokens are routed to their top-k experts; each expert takes at most
``C = ceil(T * K / E * capacity_factor)`` of the (token, k) pairs, in the
order of the token-major (token, k) sequence (a cumsum over the one-hot
assignment, no sort), and drops the rest.  The buffer (E, C, d) is gathered
through the inverse permutation (slot -> token row), the experts' SwiGLUs
run as batched products over E, and each (token, k) pair's output is
gathered back, weighted and summed over k by a reshape.

Two places where PyTorch differs from JAX, kept to the reference's result:

* ties: ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` promises no order, so the experts come from a stable
  descending sort;
* dropped slots: the reference scatters into E*C slots with
  ``mode="drop"`` for the dropped slot E*C; here the scatter has one extra
  row, sliced off.

``shard(...)`` marks the dispatch buffer and the output with the
reference's logical names (``distributed/sharding.py``; a no-op without a
sharding context).  Under a sharding context (the dry run's DTensors) the
dispatch runs as a ``local_map`` over the reference's ``moe_buf`` layout
(:func:`_moe_block_sharded`): each rank routes its batch shard's tokens and
fills the (E_loc, C_loc, D) buffer of its model rank's experts, capacity
counted per batch shard, and the output is a partial sum over the model
axis.  That is the reference's cost structure under GSPMD; a pair may drop
where the global count would keep it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (P, axis_names, get_ctx, shard,
                                              to_placements)


def stable_top_k(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, largest
    first and the lower index first among equal values (``jax.lax.top_k``'s
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_slots(flat_e: torch.Tensor, n_experts: int, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's slot in the (E * C) buffer and whether it is
    kept: its position within its expert's capacity budget, in the order of
    the token-major (token, k) sequence; a pair beyond C gets the dropped
    slot E * C."""
    E, C = n_experts, capacity
    onehot = F.one_hot(flat_e, E)                       # (TK, E)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos_t = pos.gather(1, flat_e[:, None])[:, 0]
    keep = pos_t < C
    return torch.where(keep, flat_e * C + pos_t, E * C), keep


def moe_block(p, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, D) -> (output (B, L, D), Switch aux loss, a float32
    scalar).  ``p``: router (D, E), w_gate and w_in (E, D, F), w_out
    (E, F, D)."""
    if get_ctx() is not None:
        return _moe_block_sharded(p, x, n_experts=n_experts, top_k=top_k,
                                  capacity_factor=capacity_factor)
    B, L, D = x.shape
    T = B * L
    xt = x.reshape(T, D)
    E, K = n_experts, top_k
    C = int(math.ceil(T * K / E * capacity_factor))

    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = stable_top_k(probs, K)                     # (T, K)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

    # Switch-style load-balance aux loss: E * sum_e f_e * p_e.
    flat_e = idx.reshape(-1)                            # (T*K,)
    f = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (T * K)
    aux = E * torch.sum(f * probs.mean(0))
    flat_w = w.reshape(-1).to(x.dtype)

    slot, keep = capacity_slots(flat_e, E, C)

    # Slot -> token row (T = empty), then the buffer is a row gather.
    flat_tok = torch.arange(T * K, device=x.device) // K
    inv = torch.full((E * C + 1,), T, dtype=torch.int64, device=x.device)
    inv = inv.scatter_(0, slot, flat_tok)[:E * C]
    xt_ext = torch.cat([xt, xt.new_zeros((1, D))], dim=0)
    buf = shard(xt_ext[inv].reshape(E, C, D), "moe_buf")

    # Per-expert SwiGLU: (E, C, d) @ (E, d, f).
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_in"])
    y = torch.bmm(h.to(x.dtype), p["w_out"]).reshape(E * C, D)

    # Combine: each (token, k)'s expert output, weighted, summed over k.
    safe = torch.clamp_max(slot, E * C - 1)
    contrib = torch.where(keep[:, None], flat_w[:, None] * y[safe], 0.0)
    out = contrib.reshape(T, K, D).sum(dim=1).to(x.dtype)
    return shard(out.reshape(B, L, D), "act_btd"), aux



def _moe_block_sharded(p, x, *, n_experts: int, top_k: int,
                       capacity_factor: float):
    """:func:`moe_block` on DTensors under the active sharding context, as
    a ``local_map``: tokens by batch shard (all of them with
    ``expert_tp2``, whose experts split their hidden dim on ``data``),
    experts by model rank."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    ctx = get_ctx()
    mesh, m = ctx.mesh, ctx.model_axis
    names = axis_names(mesh)
    if ctx.expert_tp2:
        x_pl = to_placements(P(None, None, None), mesh)
        w_in_pl = to_placements(P(m, None, "data"), mesh)
        w_out_pl = to_placements(P(m, "data", None), mesh)
        out_pl = [Partial() if a in (m, "data") else Replicate()
                  for a in names]
        stat_pl = [Replicate() for _ in names]
    else:
        x_pl = to_placements(P(ctx.batch_axes, None, None), mesh)
        w_in_pl = w_out_pl = to_placements(P(m, None, None), mesh)
        out_pl = [Partial() if a == m else pl for a, pl in zip(names, x_pl)]
        stat_pl = [Partial("avg") if a in ctx.batch_axes else Replicate()
                   for a in names]
    rep = [Replicate() for _ in names]
    E, K = n_experts, top_k

    def body(router, wg, wi, wo, xl):
        Bl, L, D = xl.shape
        T = Bl * L
        E_loc = wg.shape[0]
        e0 = mesh.get_local_rank(m) * E_loc
        C = int(math.ceil(T * K / E * capacity_factor))
        xt = xl.reshape(T, D)
        probs = torch.softmax((xt @ router).float(), dim=-1)
        w, idx = stable_top_k(probs, K)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        flat_e = idx.reshape(-1)
        f = torch.zeros(E, dtype=torch.float32, device=xl.device).index_add_(
            0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (T * K)
        slot, keep = capacity_slots(flat_e, E, C)
        mine = keep & (flat_e >= e0) & (flat_e < e0 + E_loc)
        slot = torch.where(mine, slot - e0 * C, E_loc * C)
        flat_tok = torch.arange(T * K, device=xl.device) // K
        inv = torch.full((E_loc * C + 1,), T, dtype=torch.int64,
                         device=xl.device)
        inv = inv.scatter_(0, slot, flat_tok)[:E_loc * C]
        buf = torch.cat([xt, xt.new_zeros((1, D))], dim=0)[inv]
        buf = buf.reshape(E_loc, C, D)
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        y = torch.bmm(h.to(xl.dtype), wo).reshape(E_loc * C, D)
        safe = torch.clamp_max(slot, E_loc * C - 1)
        contrib = torch.where(mine[:, None],
                              w.reshape(-1).to(xl.dtype)[:, None] * y[safe],
                              0.0)
        out = contrib.reshape(T, K, D).sum(dim=1).to(xl.dtype)
        return out.reshape(Bl, L, D), f, probs.mean(0)

    out, f, pm = local_map(
        body, out_placements=(out_pl, stat_pl, stat_pl),
        in_placements=(rep, w_in_pl, w_in_pl, w_out_pl, x_pl),
        device_mesh=mesh, redistribute_inputs=True)(
            p["router"], p["w_gate"], p["w_in"], p["w_out"], x)
    aux = E * torch.sum(f * pm)
    return shard(out, "act_btd"), aux
