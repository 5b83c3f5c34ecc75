"""The Mamba-2 SSD chunked scan (the prefill hot-spot of the SSM layers):
the wrapper around the CUDA kernel ``csrc/ssd_chunk.cu`` (K4) with its
plain PyTorch version beside it.

:func:`ssd_chunked` is the counterpart of the JAX package's
``ssd_chunked_tpu``: x (B, L, H, dh), dt (B, L, H), A (H,), B and C
(B, L, N) shared by the heads, D (H,); L % Q == 0.  It returns y (B, L, H,
dh) in x's dtype and the final state (B, H, dh, N) in float32.  For
tensors on the card it launches the kernel (four launches on the card a
call, counted once in ``LAUNCHES``) with workspaces it allocates
(:func:`workspace_shapes`); for tensors on the CPU (or on the meta
device, which the dry run's placeholder ranks use) it runs the plain
version; anything else raises.  Each call is reported to an active
``launch/cost_analysis.py`` counter as one fused call.  With grad enabled
and an input that requires grad, a card call goes through
:class:`SSDChunkedFn`: its forward launches the kernel and keeps only the
inputs; its backward recomputes the plain version and differentiates it,
through y and the final state (the reference's kernel is forward-only,
and its training runs its plain path).

:func:`ssd_scan` is the plain version, written from the Pallas body: per
chunk of Q rows the decay ``exp(segsum(dt*A))`` (never exponentiated above
the diagonal), ``y = (C Bᵀ ⊙ L)(dt ⊙ x) + exp(cum)·(C stateᵀ) + D·x``, then
the state update, for all (batch, head) pairs at once.  It also takes a
carried-in state and a length that is no multiple of Q (zero-padded, as the
JAX package's jnp path pads), so it serves as the model's path where the
kernel does not apply.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import count_launch, library
from repro_torch.launch import cost_analysis

# Kernel launches since the last reset_launches() (plain runs do not count).
LAUNCHES = {"ssd_chunked": 0}
# What the kernel takes (its padded tiles, csrc/ssd_chunk.cu).
MAX_DH, MAX_N = 64, 128


def reset_launches() -> None:
    LAUNCHES["ssd_chunked"] = 0


def segsum(a: torch.Tensor) -> torch.Tensor:
    """``L[i, j] = sum_{k=j+1..i} a[k]`` for ``i >= j``, else -inf (so its
    exp is 0 and no overflow above the diagonal reaches a product).
    a: (..., Q)."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(upper, float("-inf"))


def ssd_scan(x, dt, A, Bm, Cm, D, *, Q: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over chunks of Q rows in float32; returns (y in x's dtype, final
    state (B, H, dh, N) float32).  Rows past L are zero padding: dt = 0
    there, so they leave the state as it is."""
    Bb, L, H, dh = x.shape
    nc = -(-L // Q)
    pad = nc * Q - L
    xf, dtf, bf, cf = (t.float() for t in (x, dt, Bm, Cm))
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, pad))
    a = dtf * A.float()[None, None, :]                  # (B, Lp, H)
    state = (torch.zeros((Bb, H, dh, Bm.shape[-1]), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    Dh = D.float()[None, :, None, None]
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq = xf[:, sl].permute(0, 2, 1, 3)              # (B, H, Q, dh)
        dtq = dtf[:, sl].permute(0, 2, 1)               # (B, H, Q)
        bq, cq = bf[:, sl], cf[:, sl]                   # (B, Q, N)
        aq = a[:, sl].permute(0, 2, 1)                  # (B, H, Q)
        cum = torch.cumsum(aq, dim=-1)
        lmat = torch.exp(segsum(aq))                    # (B, H, i, j)
        w = (cq @ bq.transpose(1, 2))[:, None] * lmat
        y_diag = w @ (dtq[..., None] * xq)
        y_state = torch.exp(cum)[..., None] * (cq[:, None]
                                               @ state.transpose(-1, -2))
        ys.append(y_diag + y_state + Dh * xq)
        total = cum[..., -1]                            # (B, H)
        decay_out = torch.exp(total[..., None] - cum)   # (B, H, Q)
        upd = ((decay_out * dtq)[..., None] * xq).transpose(-1, -2) \
            @ bq[:, None]                               # (B, H, dh, N)
        state = torch.exp(total)[..., None, None] * state + upd
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :L]
    return y.to(x.dtype), state


def ssd_chunked_plain(x, dt, A, Bm, Cm, D, *, Q: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (no carried-in state)."""
    return ssd_scan(x, dt, A, Bm, Cm, D, Q=Q)


def workspace_shapes(B: int, L: int, H: int, dh: int, N: int, Q: int):
    """The kernel's float32 workspaces (csrc/ssd_chunk.cu): C Bᵀ per
    (batch, chunk), (B, nc, QP, QP); each chunk's own state, then the state
    it carries in, transposed, (B, H, nc, NP, DHP); cum and dt, (B, H, nc,
    QP, 2).  QP is Q rounded up to 64, DHP dh up to 16, NP N up to 8, nc =
    L / Q."""
    nc = L // Q
    QP, DHP, NP = (-(-v // m) * m for v, m in ((Q, 64), (dh, 16), (N, 8)))
    return (B, nc, QP, QP), (B, H, nc, NP, DHP), (B, H, nc, QP, 2)


def _check(x, dt, A, Bm, Cm, D, Q: int) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 4:
        raise ValueError("x must be (B, L, H, dh)")
    Bb, L, H, dh = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != (Bb, L, H) or A.shape != (H,) or D.shape != (H,) \
            or Bm.shape != (Bb, L, N) or Cm.shape != (Bb, L, N):
        raise ValueError("shapes must be x (B, L, H, dh), dt (B, L, H), "
                         "A and D (H,), B and C (B, L, N)")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError("x, B and C must all be float32 or all bfloat16")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise ValueError("dt, A and D must be float32")
    if any(t.device != x.device for t in (dt, A, Bm, Cm, D)):
        raise ValueError("all inputs must be on one device")
    if Q < 1 or L % Q:
        raise ValueError(f"L = {L} must be a multiple of Q = {Q}")


def _launch(x, dt, A, Bm, Cm, D, Q: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the kernel (four launches) on card tensors that
    ``_check`` passed."""
    Bb, L, H, dh = x.shape
    N = Bm.shape[-1]
    if dh > MAX_DH or N > MAX_N:
        raise ValueError(f"the kernel takes dh <= {MAX_DH} and N <= {MAX_N},"
                         f" not {dh} and {N}")
    ins = (x, dt, A, Bm, Cm, D)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("the kernel takes contiguous tensors only")
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, dh, N), dtype=torch.float32, device=x.device)
    work = [torch.empty(shape, dtype=torch.float32, device=x.device)
            for shape in workspace_shapes(Bb, L, H, dh, N, Q)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = library("ssd_chunk").ssd_chunk_fwd(
            *(t.data_ptr() for t in (*ins, y, state, *work)), Bb, L, H, dh,
            N, Q, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"SSD chunk kernel launch failed: CUDA error {err}")
    count_launch(LAUNCHES, "ssd_chunked")
    cost_analysis.report_kernel("ssd_chunked", ssd_chunked_plain,
                                (x, dt, A, Bm, Cm, D), (y, state), Q=Q)
    return y, state


class SSDChunkedFn(torch.autograd.Function):
    """K4 under autograd: the forward launches the kernel (on meta tensors,
    the dry run's placeholders for the card, it counts the plain version as
    one fused call) and saves only its inputs; the backward recomputes
    :func:`ssd_chunked_plain` on them with grad enabled and returns its
    gradients through y and the final state."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, Q: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.Q = Q
        if x.device.type == "meta":
            return cost_analysis.fused("ssd_chunked", ssd_chunked_plain,
                                       (x, dt, A, Bm, Cm, D), Q=Q)
        return _launch(x, dt, A, Bm, Cm, D, Q)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad[:6])]
        with torch.enable_grad():
            outs = ssd_chunked_plain(*ins, Q=ctx.Q)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt, (grad_y, grad_state),
                                             allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None)


def ssd_chunked(x, dt, A, Bm, Cm, D, *, Q: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan with chunk length Q; returns (y (B, L, H, dh) in x's dtype,
    final state (B, H, dh, N) float32)."""
    _check(x, dt, A, Bm, Cm, D, Q)
    ins = (x, dt, A, Bm, Cm, D)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    if x.device.type == "cpu" or (x.device.type == "meta" and not grad):
        return cost_analysis.fused("ssd_chunked", ssd_chunked_plain, ins,
                                   Q=Q)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    if grad:
        return SSDChunkedFn.apply(*ins, Q)
    return _launch(*ins, Q)
