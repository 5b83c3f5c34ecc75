"""Transformer building blocks: RMSNorm, RoPE, attention (GQA, sliding
window, softcap, KV cache), the gated MLP and the GELU MLP, as the JAX
package's ``models/layers.py`` computes them.

Parameters are read by name (``p["wq"]``) from a mapping or a module of the
port's models.  ``shard(...)`` (``distributed/sharding.py``) annotates
activations with the reference's logical names: it returns its input
without a sharding context, and redistributes a DTensor under one.

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

from repro_torch.distributed.sharding import P, constrain, get_ctx, shard
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
    if KV != H and get_ctx() is not None:
        q, k, v = _heads_for_dtensor(q, k, v)
        KV = k.shape[2]
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


def _heads_for_dtensor(q, k, v):
    """GQA under a sharding context (DTensors): splitting a sharded head
    dim into (KV, G) groups fails where KV does not divide the model axis.
    One query token (decode) gathers q's heads (a few KB); a sequence
    repeats K and V to every head and places them as q where q splits
    heads or head_dim (so that no key chunk moves), as K itself where q
    splits the sequence.  Both give the same scores; a repeat's gradient
    comes back in K's placement (its head dim whole)."""
    ctx = get_ctx()
    if q.shape[1] == 1:
        return constrain(q, P(ctx.batch_axes, None, None, None),
                         ctx.mesh), k, v
    G = q.shape[2] // k.shape[2]
    like = "act_bthd" if ctx.attn_q_axis in ("heads", "hd") else "kv_cache"
    return q, *(shard(t.repeat_interleave(G, dim=2), like) for t in (k, v))


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
    q = shard(q, "act_bthd")
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
    k = shard(k, "kv_cache")
    v = shard(v, "kv_cache")
    out = flash_attention(q, k, v, q_positions=positions, s_valid=s_valid,
                          causal=causal and xkv is None and not cross_cached,
                          window=window, softcap=softcap, kv_chunk=kv_chunk)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"]).to(x.dtype)
    return shard(y, "act_btd"), cache


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    h = shard(h.to(x.dtype), "act_btf")
    return shard((h @ p["w_out"]).to(x.dtype), "act_btd")


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU MLP (``jax.nn.gelu``'s default)."""
    h = F.gelu(x @ p["w_in"], approximate="tanh")
    h = shard(h.to(x.dtype), "act_btf")
    return shard((h @ p["w_out"]).to(x.dtype), "act_btd")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``: ``F.embedding``, the same bits
    as ``table[tokens]``, and the gather DTensor shards on the vocab."""
    return shard(F.embedding(tokens, table), "act_btd")


def unembed(table: torch.Tensor, x: torch.Tensor,
            logit_softcap: float = 0.0) -> torch.Tensor:
    logits = (x @ table.T).float()
    if logit_softcap > 0.0:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    return shard(logits, "logits")
