"""Mamba-2 SSD (state-space duality) block, as the JAX package's
``models/ssm.py`` computes it.

Prefill uses the chunked SSD algorithm: the sequence is cut into Q-length
chunks; within a chunk the recurrence is computed in its dual quadratic
(attention-like) form, and the (B, H, dh, N) state is carried across
chunks.  Decode is the O(1) recurrent step.

State-space recurrence (per head h, discretized):
    s_t = exp(dt_t * A) * s_{t-1} + dt_t * B_t x_t^T      (s: (dh, N))
    y_t = s_t C_t + D * x_t

Under the JAX package's kernel conditions (no carried-in state,
``L % 128 == 0``) the chunked scan goes to the SSD kernel (K4,
``kernels/ssd_chunk.py``) at the reference's choice of Q: on the card the
CUDA kernel by default, or its plain version after
``set_ssd_impl("plain")``, which only tests and the smoke's comparisons
select.  A carried-in state or another length takes the plain scan.
``shard(...)`` marks the heads and the output with the reference's logical
names (``distributed/sharding.py``; a no-op without a sharding context).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard
from repro_torch.kernels import ssd_chunk as k4

# The reference's ssm._segsum; it lives beside K4's plain version, which
# uses it.
_segsum = k4.segsum

# "kernel": K4's wrapper (the CUDA kernel for tensors on the card);
# "plain": K4's plain version wherever the kernel would run.
_SSD_IMPL = "kernel"


def set_ssd_impl(impl: str) -> str:
    """Select K4's kernel or its plain version; returns the previous
    choice."""
    global _SSD_IMPL
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown SSD implementation {impl!r}")
    prev, _SSD_IMPL = _SSD_IMPL, impl
    return prev


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 256,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, dh); dt: (B, L, H); A: (H,) negative; Bm/Cm: (B, L, N);
    D: (H,).  Returns (y (B, L, H, dh), final_state (B, H, dh, N))."""
    L = x.shape[1]
    if init_state is None and L % 128 == 0:
        Qk = min(max(chunk, 128), 256)
        while L % Qk:
            Qk //= 2
        Q = max(Qk, 128) if L % max(Qk, 128) == 0 else L
        fn = (k4.ssd_chunked if _SSD_IMPL == "kernel"
              else k4.ssd_chunked_plain)
        return fn(x.contiguous(), dt.float().contiguous(), A.float(),
                  Bm.contiguous(), Cm.contiguous(), D.float(), Q=Q)
    return k4.ssd_scan(x, dt, A, Bm, Cm, D, Q=min(chunk, L),
                       init_state=init_state)


def ssd_decode_step(x, dt, A, Bm, Cm, D, state
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent step.  x: (B, H, dh); dt: (B, H); Bm/Cm: (B, N);
    state: (B, H, dh, N)."""
    decay = torch.exp(dt * A[None, :]).float()             # (B, H)
    upd = (dt.float()[..., None] * x.float())[..., None] \
        * Bm.float()[:, None, None, :]
    state = decay[..., None, None] * state + upd
    y = (state @ Cm.float()[:, None, :, None])[..., 0]
    y = y + D[None, :, None] * x.float()
    return y.to(x.dtype), state


def mamba_dims(d_model: int, expand: int, head_dim: int, state: int):
    d_inner = expand * d_model
    H = d_inner // head_dim
    conv_dim = d_inner + 2 * state
    return d_inner, H, conv_dim


def mamba_block(p, x: torch.Tensor, *, head_dim: int, state: int,
                expand: int = 2, conv_k: int = 4, chunk: int = 256,
                cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B, L, D).  cache (decode): {"conv": (B, k-1, conv_dim),
    "state": (B, H, dh, N)}, updated in place and returned; L must be 1 in
    decode."""
    B, L, D = x.shape
    d_inner, H, conv_dim = mamba_dims(D, expand, head_dim, state)

    zxbcdt = (x @ p["w_in"]).to(x.dtype)
    z, xbc, dt = zxbcdt.split([d_inner, conv_dim, H], dim=-1)
    zero = torch.zeros((), device=x.device)
    dt = torch.logaddexp(dt.float() + p["dt_bias"], zero)   # softplus

    conv_w = p["conv_w"]
    if cache is None:
        # causal depthwise conv over the sequence
        pad_x = F.pad(xbc, (0, 0, conv_k - 1, 0))
        xbc = pad_x[:, 0:L] * conv_w[0]
        for i in range(1, conv_k):
            xbc = xbc + pad_x[:, i:i + L] * conv_w[i]
        new_cache = None
    else:
        hist = torch.cat([cache["conv"], xbc], dim=1)     # (B, k, c)
        xbc = (hist * conv_w[None]).sum(1)[:, None, :]
        cache["conv"].copy_(hist[:, 1:])
        new_cache = cache
    xbc = F.silu(xbc)

    x_ssm, Bm, Cm = xbc.split([d_inner, state, state], dim=-1)
    x_ssm = shard(x_ssm.reshape(B, L, H, head_dim), "act_bthd")
    A = -torch.exp(p["A_log"])                            # (H,)

    if cache is None:
        y, _ = ssd_chunked(x_ssm, dt, A, Bm, Cm, p["D"], chunk=chunk)
    else:
        y, s = ssd_decode_step(x_ssm[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                               p["D"], cache["state"])
        cache["state"].copy_(s)
        y = y[:, None]
    y = y.reshape(B, L, d_inner)
    y = y * F.silu(z)
    out = y.to(x.dtype) @ p["w_out"]
    return shard(out, "act_btd"), new_cache
