"""Transformer building blocks: RMSNorm, RoPE, attention (GQA, sliding
window, softcap, KV cache), the gated MLP and the GELU MLP, as the JAX
package's ``models/layers.py`` computes them.

Parameters are read by name (``p["wq"]``) from a mapping or a module of the
port's models.  The JAX package's ``shard(...)`` and ``gather_fsdp(...)``
annotate arrays for a device mesh and do nothing on one device without one;
this one-device port omits them.

Attention is the online-softmax (flash) form.  Under the JAX package's
kernel conditions (``Lq == S``, no window, no partly filled cache,
``Lq % 128 == 0``) it goes to the flash-attention kernel (K3,
``kernels/flash_attention.py``), with the reference's block sizes cut to
ones that divide the lengths (``gcd(L, 256)``: the reference's ``min(256,
L)`` does not divide L = 384 or 640, where its Pallas toggle asserts and its
default path runs): on the card the CUDA kernel by default, or
its plain PyTorch version after ``set_flash_impl("plain")``, which only tests
and the smoke's comparisons select.  One query token against a cache takes
the direct form; every other case takes the plain chunk scan.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as k3

NEG_INF = k3.NEG_INF

# "kernel": K3's wrapper (the CUDA kernel for tensors on the card);
# "plain": K3's plain version wherever the kernel would run.
_FLASH_IMPL = "kernel"


def set_flash_impl(impl: str) -> str:
    """Select K3's kernel or its plain version; returns the previous
    choice."""
    global _FLASH_IMPL
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown attention implementation {impl!r}")
    prev, _FLASH_IMPL = _FLASH_IMPL, impl
    return prev


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """``x / rms(x) * (1 + w)`` in float32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding on split halves.  x: (..., L, H, hd); positions
    (L,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(x.device)[:, None].float() * freqs[None, :]
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, s_valid: int,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Online-softmax attention.  q: (B, Lq, H, hd); k, v: (B, S, KV, hd)
    with H = KV * G; ``q_positions`` (Lq,) absolute; keys at or past
    ``s_valid`` are masked (decode with a partly filled cache)."""
    B, Lq, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if Lq > 1 and Lq == S and window == 0 and s_valid == S and Lq % 128 == 0:
        fn = (k3.flash_attention if _FLASH_IMPL == "kernel"
              else k3.flash_attention_plain)
        return fn(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, softcap=softcap, Bq=math.gcd(Lq, 256),
                  Bk=math.gcd(S, 256))
    if Lq == 1:
        # Decode: one query against the whole cache, read once in its own
        # dtype and summed in float32.
        G = H // KV
        qg = q.reshape(B, 1, KV, G, hd).to(k.dtype).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
        s = s * (1.0 / math.sqrt(hd))
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        kpos = torch.arange(S, device=q.device)
        qpos = q_positions.to(q.device)[:, None]
        valid = kpos[None, :] < s_valid
        if causal:
            valid = valid & (qpos >= kpos[None, :])
        if window > 0:
            valid = valid & (qpos - kpos[None, :] < window)
        s = torch.where(valid[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                           v.float())
        return out.reshape(B, 1, H, hd).to(q.dtype)
    return k3.attention_chunked(q, k, v, q_positions=q_positions,
                                s_valid=s_valid, causal=causal, window=window,
                                softcap=softcap, kv_chunk=kv_chunk)


def attention(p, x: torch.Tensor, *, n_heads: int, n_kv: int, hd: int,
              rope_theta: float, positions: torch.Tensor,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              kv_chunk: int = 1024, xkv: Optional[torch.Tensor] = None,
              use_rope: bool = True, cross_cached: bool = False
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA attention with an optional KV cache (decode) and cross-attention
    (``xkv`` supplies the key/value sequence, or ``cross_cached=True`` marks
    the cache as holding already-projected encoder memory).  A
    self-attention cache (``{"k", "v"}``, (B, S, KV, hd)) is written in
    place at ``cache_pos`` and returned."""
    src = x if xkv is None else xkv
    q = torch.einsum("btd,dhk->bthk", x, p["wq"]).to(x.dtype)
    if use_rope:
        q = rope(q, positions, rope_theta)
    if cache is not None and xkv is None and not cross_cached:
        k_new = torch.einsum("btd,dhk->bthk", src, p["wk"]).to(x.dtype)
        if use_rope:
            k_new = rope(k_new, positions, rope_theta)
        v_new = torch.einsum("btd,dhk->bthk", src, p["wv"]).to(x.dtype)
        pos = int(cache_pos)
        cache["k"][:, pos:pos + x.shape[1]] = k_new
        cache["v"][:, pos:pos + x.shape[1]] = v_new
        k, v = cache["k"], cache["v"]
        s_valid = pos + x.shape[1]
    elif cache is not None:
        k, v = cache["k"], cache["v"]
        s_valid = k.shape[1]
    else:
        k = torch.einsum("btd,dhk->bthk", src, p["wk"]).to(x.dtype)
        if use_rope:
            k_pos = (positions if xkv is None
                     else torch.arange(src.shape[1], device=x.device))
            k = rope(k, k_pos, rope_theta)
        v = torch.einsum("btd,dhk->bthk", src, p["wv"]).to(x.dtype)
        s_valid = k.shape[1]
    out = flash_attention(q, k, v, q_positions=positions, s_valid=s_valid,
                          causal=causal and xkv is None and not cross_cached,
                          window=window, softcap=softcap, kv_chunk=kv_chunk)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"]).to(x.dtype)
    return y, cache


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    return (h.to(x.dtype) @ p["w_out"]).to(x.dtype)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU MLP (``jax.nn.gelu``'s default)."""
    h = F.gelu(x @ p["w_in"], approximate="tanh")
    return (h.to(x.dtype) @ p["w_out"]).to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor,
            logit_softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ table.T).float()
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    return logits
