"""Flash attention (the prefill hot-spot of the attention layers): the
wrapper around the CUDA kernel ``csrc/flash_attention.cu`` (K3) with its
plain PyTorch version beside it.

:func:`flash_attention` is the counterpart of the JAX package's
``flash_attention_tpu``: q (B, L, H, hd), k and v (B, S, KV, hd) with
H = KV * G, causal or not, an optional tanh softcap, scale 1/sqrt(hd),
online softmax in float32, output in q's dtype.  It launches the kernel for
tensors on the card (counted in ``LAUNCHES``) and runs the plain version for
tensors on the CPU (or on the meta device, which the dry run's placeholder
ranks use); anything else raises.  Each call is reported to an active
``launch/cost_analysis.py`` counter as one fused call.  With grad enabled
and an input that requires grad, a card call goes through
:class:`FlashAttentionFn`: its forward launches the kernel and keeps only
q, k and v; its backward recomputes the plain version and differentiates
it (the reference's kernel is forward-only, and its training runs its
plain path).

:func:`attention_chunked` is the plain version: the online-softmax scan
over key chunks written from the Pallas body, generalised to the cases the
model's attention needs besides the kernel's (absolute query positions, a
partly filled cache, a sliding window).  Blocking the queries and skipping
key blocks wholly in the future, as the kernel does, changes no value, so
one scan serves as the kernel's plain version and as the model's path where
the kernel does not apply.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._build import count_launch, library
from repro_torch.launch import cost_analysis

NEG_INF = -1e30
# Kernel launches since the last reset_launches() (plain runs do not count).
LAUNCHES = {"flash_attention": 0}
# Largest head dimension the kernel takes (csrc/flash_attention.cu).
MAX_HD = 128


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, s_valid: int,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over key chunks of ``kv_chunk``, in float32.

    q (B, Lq, H, hd); k, v (B, S, KV, hd); ``q_positions`` (Lq,) absolute;
    keys at or past ``s_valid`` are masked (a partly filled cache); with
    ``window > 0`` a key more than ``window - 1`` behind its query is masked
    too.  q is scaled by 1/sqrt(hd) before the product, as in the Pallas
    body; masked scores are ``NEG_INF``, and the result is
    ``acc / max(l, 1e-30)`` in q's dtype."""
    B, Lq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    ck = min(kv_chunk, S)
    qg = (q.float() * (1.0 / math.sqrt(hd))).reshape(B, Lq, KV, G, hd)
    qg = qg.permute(0, 2, 3, 1, 4)                       # (B, KV, G, Lq, hd)
    # made like qg, so that a sharded q (a DTensor) gives sharded buffers
    acc = torch.zeros_like(qg, memory_format=torch.contiguous_format)
    m = torch.full_like(qg[..., 0], NEG_INF,
                        memory_format=torch.contiguous_format)
    l = torch.zeros_like(m)
    qpos = q_positions.to(q.device)[:, None]
    for c0 in range(0, S, ck):
        kb = k[:, c0:c0 + ck].float().permute(0, 2, 1, 3)[:, :, None]
        vb = v[:, c0:c0 + ck].float().permute(0, 2, 1, 3)[:, :, None]
        s = qg @ kb.transpose(-1, -2)                    # (B, KV, G, Lq, c)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        kpos = torch.arange(c0, c0 + kb.shape[3], device=q.device)[None, :]
        valid = kpos < s_valid
        if causal:
            valid = valid & (qpos >= kpos)
        if window > 0:
            valid = valid & (qpos - kpos < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, hd).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          softcap: float = 0.0, Bq: int = 256,
                          Bk: int = 256) -> torch.Tensor:
    """The kernel's function in plain PyTorch: every query at its own
    index, every key valid, key blocks of ``Bk``."""
    del Bq  # query blocking changes no value
    return attention_chunked(q, k, v, q_positions=torch.arange(q.shape[1]),
                             s_valid=k.shape[1], causal=causal,
                             softcap=softcap, kv_chunk=Bk)


def _check(q, k, v, Bq: int, Bk: int) -> None:
    """Raise on anything the kernel does not take (the reference asserts
    ``L % Bq == S % Bk == 0``)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be (B, L, H, hd), k and v (B, S, KV, hd)")
    B, L, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}: H must be a multiple of KV")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must all be float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if L % Bq or k.shape[1] % Bk:
        raise ValueError(f"L = {L} and S = {k.shape[1]} must be multiples "
                         f"of Bq = {Bq} and Bk = {Bk}")


def _launch(q, k, v, causal: bool, softcap: float) -> torch.Tensor:
    """One launch of the kernel on card tensors that ``_check`` passed."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if hd > MAX_HD:
        raise ValueError(f"the kernel takes hd <= {MAX_HD}, not {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors only")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = library("flash_attention").flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L,
            S, H, KV, hd, int(causal), float(softcap), 1.0 / math.sqrt(hd),
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(LAUNCHES, "flash_attention")
    cost_analysis.report_kernel("flash_attention", flash_attention_plain,
                                (q, k, v), out, causal=causal,
                                softcap=softcap)
    return out


class FlashAttentionFn(torch.autograd.Function):
    """K3 under autograd: the forward launches the kernel (on meta tensors,
    the dry run's placeholders for the card, it counts the plain version as
    one fused call) and saves only its inputs; the backward recomputes
    :func:`flash_attention_plain` on them with grad enabled and returns its
    gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, softcap: float, Bk: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, softcap, Bk)
        if q.device.type == "meta":
            return cost_analysis.fused("flash_attention",
                                       flash_attention_plain, (q, k, v),
                                       causal=causal, softcap=softcap, Bk=Bk)
        return _launch(q, k, v, causal, softcap)

    @staticmethod
    def backward(ctx, grad):
        causal, softcap, Bk = ctx.args
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = flash_attention_plain(*ins, causal=causal, softcap=softcap,
                                        Bk=Bk)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        return (*(next(grads) if t.requires_grad else None for t in ins),
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float = 0.0, Bq: int = 256,
                    Bk: int = 256) -> torch.Tensor:
    """Attention of q (B, L, H, hd) over k, v (B, S, KV, hd); returns
    (B, L, H, hd) in q's dtype.  ``Bq``/``Bk`` are the reference's block
    sizes: L and S must be multiples of them (the kernel tiles by its own
    block shape whatever they are; ``Bk`` is the key chunk of the plain
    version, and of the backward's recompute)."""
    _check(q, k, v, Bq, Bk)
    opts = dict(causal=causal, softcap=softcap, Bq=Bq, Bk=Bk)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if q.device.type == "cpu" or (q.device.type == "meta" and not grad):
        return cost_analysis.fused("flash_attention", flash_attention_plain,
                                   (q, k, v), **opts)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    if grad:
        return FlashAttentionFn.apply(q, k, v, causal, float(softcap), Bk)
    return _launch(q, k, v, causal, softcap)
