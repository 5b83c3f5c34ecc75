"""Explicit all-to-all MoE dispatch and combine, as the JAX package's
``distributed/moe_a2a.py`` computes them, over ``torch.distributed``.

Tokens are sharded over the model axis too (the sequence dim), and
dispatch and combine are all-to-all exchanges whose payload is 1/|model|
of the dense path's all-reduce of (T_local, D) partials.

Layout (every rank of the mesh runs the same program on its block):
  x        (B, L, D)   P(b, m, None)    — L split over m: T_loc tokens
  router   (D, E)      replicated
  experts  (E, D, F)   P(m, None, None) — E_loc experts per m-rank
Per rank: route locally -> bucket (token, k) pairs by target expert rank
(fixed per-target capacity ``Cs``, drops over it) -> all-to-all tokens to
the expert owners -> per-expert FFN (capacity ``Ce`` an expert,
inverse-permutation gather, as ``models/moe.py``) -> all-to-all results
back -> weighted combine (a reshape-sum over k).  The exchanges are
``torch.distributed.nn.functional.all_to_all_single``, which is
differentiable: the backward pass is the mirrored exchange.

Numerics match ``models/moe.py::moe_block`` up to capacity-drop
differences (capacity here is per (source rank, target rank), there per
expert); with a capacity factor large enough, neither drops.  Top-k is the
port's ``stable_top_k``: ties go to the lower index, as ``jax.lax.top_k``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn
import torch.nn.functional as F

from repro_torch.distributed.sharding import (P, axis_names, axis_sizes,
                                              to_placements)
from repro_torch.models.moe import stable_top_k


def _inv_permute(slot: torch.Tensor, n_slots: int, n_src: int
                 ) -> torch.Tensor:
    """slot (n_src,) -> inv (n_slots,) with inv[slot[i]] = i; n_src marks
    empty slots (slot n_slots, a dropped pair, lands in an extra row that
    is sliced off)."""
    inv = torch.full((n_slots + 1,), n_src, dtype=torch.int64,
                     device=slot.device)
    inv.scatter_(0, slot, torch.arange(n_src, device=slot.device))
    return inv[:n_slots]


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over ``group`` (differentiable: the backward sums the
    gradients over the group)."""
    n = dist.get_world_size(group)
    return dfn.all_reduce(x, group=group) / n if n > 1 else x


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all of ``x``'s leading dim (m equal blocks, block j to
    rank j of ``group``), differentiable."""
    if dist.get_world_size(group) == 1:
        return x
    return dfn.all_to_all_single(torch.empty_like(x), x.contiguous(),
                                 group=group)


def moe_ffn_a2a(p, xt: torch.Tensor, *, n_experts: int, top_k: int, group,
                capacity_factor: float = 1.5
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank body.  xt: (T_loc, D); ``p`` holds ``router`` (D, E) and
    this rank's expert slices ``w_gate``/``w_in`` (E_loc, D, F) and
    ``w_out`` (E_loc, F, D); ``group`` is the model axis's process group.
    Returns (out (T_loc, D), aux)."""
    T, D = xt.shape
    E, K = n_experts, top_k
    m = dist.get_world_size(group)
    E_loc = E // m

    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = stable_top_k(probs, K)                       # (T, K)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # load-balance aux (global mean over the group)
    flat_e = idx.reshape(-1)                              # (TK,)
    f = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.float32)) / (T * K)
    aux = E * torch.sum(_pmean(f, group) * _pmean(probs.mean(0), group))

    flat_w = w.reshape(-1).to(xt.dtype)
    TK = T * K
    target = flat_e // E_loc                              # dest m-rank
    e_local = flat_e % E_loc

    # --- bucket by target rank (fixed per-target capacity Cs) -----------
    Cs = int(math.ceil(TK / m * capacity_factor))
    onehot_t = F.one_hot(target, m)
    pos = torch.cumsum(onehot_t, dim=0) - onehot_t
    pos_t = pos.gather(1, target[:, None])[:, 0]
    keep = pos_t < Cs
    slot = torch.where(keep, target * Cs + pos_t, m * Cs)  # m*Cs = dropped

    inv = _inv_permute(slot, m * Cs, TK)                  # slot -> (t, k)
    src_tok = torch.cat([xt, xt.new_zeros((1, D))], 0)
    filled = inv < TK
    send_tok = src_tok[torch.where(filled, inv // K, T)]  # (m*Cs, D)
    send_e = torch.where(filled, e_local[torch.clamp_max(inv, TK - 1)],
                         E_loc)                           # E_loc = invalid

    # --- exchange: every rank ships its buckets to the expert owners ----
    recv_tok = _exchange(send_tok, group)                 # (m*Cs, D)
    if m > 1:
        recv_e = torch.empty_like(send_e)
        dist.all_to_all_single(recv_e, send_e.contiguous(), group=group)
    else:
        recv_e = send_e

    # --- local per-expert FFN (inverse-permutation gather) --------------
    R = m * Cs
    Ce = int(math.ceil(R / E_loc * capacity_factor))
    valid = recv_e < E_loc
    onehot_e = F.one_hot(torch.where(valid, recv_e, E_loc),
                         E_loc + 1)[:, :E_loc]
    pos_e = torch.cumsum(onehot_e, dim=0) - onehot_e
    pos_r = pos_e.gather(1, torch.clamp_max(recv_e, E_loc - 1)[:, None])[:, 0]
    keep_r = valid & (pos_r < Ce)
    slot_r = torch.where(keep_r, recv_e * Ce + pos_r, E_loc * Ce)
    inv_r = _inv_permute(slot_r, E_loc * Ce, R)
    buf = torch.cat([recv_tok, recv_tok.new_zeros((1, D))], 0)[
        torch.clamp_max(inv_r, R)].reshape(E_loc, Ce, D)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_in"])
    y = torch.bmm(h.to(xt.dtype), p["w_out"]).reshape(E_loc * Ce, D)

    # back to the receive layout, then the return exchange
    y_recv = torch.where(keep_r[:, None],
                         y[torch.clamp_max(slot_r, E_loc * Ce - 1)], 0.0)
    back = _exchange(y_recv, group)                       # (m*Cs, D)

    # --- combine at the source: weight and reshape-sum over k -----------
    safe = torch.clamp_max(slot, m * Cs - 1)
    contrib = torch.where(keep[:, None], flat_w[:, None] * back[safe], 0.0)
    out = contrib.reshape(T, K, D).sum(dim=1).to(xt.dtype)
    return out, aux


def _block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (even splits;
    a tuple entry splits major to minor)."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n, i = 1, 0
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i = i * sizes[a] + mesh.get_local_rank(a)
            n *= sizes[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"{n} ways")
        x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n)
    return x


def moe_block_a2a(p, x: torch.Tensor, mesh, *, n_experts: int, top_k: int,
                  batch_axes=("data",), model_axis: str = "model",
                  capacity_factor: float = 1.5):
    """x (B, L, D), sharded (batch_axes, model_axis); expert weights
    sharded on the expert dim; router replicated.  Every rank of ``mesh``
    calls this with the global ``x`` and ``p`` (a DTensor ``x`` is taken
    as its global value) and works on its block.  Returns (the output as a
    DTensor placed P(batch_axes, model_axis, None), aux: the mean over the
    mesh, a plain scalar on every rank)."""
    from torch.distributed.tensor import DTensor
    b = tuple(a for a in batch_axes if a in axis_names(mesh))
    xspec = P(b or None, model_axis, None)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    xs = _block(x, xspec, mesh)
    espec = P(model_axis, None, None)
    local = {"router": p["router"],
             **{k: _block(p[k], espec, mesh)
                for k in ("w_gate", "w_in", "w_out")}}
    B, Ll, D = xs.shape
    out, aux = moe_ffn_a2a(local, xs.reshape(B * Ll, D), n_experts=n_experts,
                           top_k=top_k, group=mesh.get_group(model_axis),
                           capacity_factor=capacity_factor)
    aux = _pmean(aux, mesh.get_group(model_axis))
    if b:
        aux = _pmean(aux, mesh.get_group(b[0]))
    out = DTensor.from_local(out.reshape(B, Ll, D), mesh,
                             to_placements(xspec, mesh), run_check=False)
    return out, aux
