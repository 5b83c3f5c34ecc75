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

The reference's ``shard(...)`` does nothing on one device and is omitted.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


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
    buf = xt_ext[inv].reshape(E, C, D)

    # Per-expert SwiGLU: (E, C, d) @ (E, d, f).
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_in"])
    y = torch.bmm(h.to(x.dtype), p["w_out"]).reshape(E * C, D)

    # Combine: each (token, k)'s expert output, weighted, summed over k.
    safe = torch.clamp_max(slot, E * C - 1)
    contrib = torch.where(keep[:, None], flat_w[:, None] * y[safe], 0.0)
    out = contrib.reshape(T, K, D).sum(dim=1).to(x.dtype)
    return out.reshape(B, L, D), aux

