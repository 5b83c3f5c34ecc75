"""Whisper-style encoder-decoder, as the JAX package's ``models/encdec.py``
defines it.

The conv audio frontend is a stub: the batch supplies precomputed frame
embeddings (B, frames, d_model).  Encoder: bidirectional attention over the
frames.  Decoder: causal self-attention, cross-attention to the encoder's
output, GELU MLPs.  RoPE stands in for Whisper's learned positional
embeddings (the reference's frontend-stub deviation).

Attention dispatch.  The encoder's frames (1,500 at full size) and the
cross-attention (queries against the frames) do not meet flash attention's
conditions (``Lq == S``, ``Lq % 128 == 0``) and take the plain chunk scan;
the decoder's causal self-attention goes to the kernel (K3) at ``L % 128 ==
0``.  The stacks are ``nn.ModuleList``s of layer modules walked by Python
loops (:func:`build_model`), as in ``models/transformer.py``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ATTN_LOGICAL, MLP_LOGICAL,
                                              gather_fsdp, shard_seq)
from repro_torch.models import layers as ll
from repro_torch.models.params import PDef, check_tree, layer
from repro_torch.models.transformer import (LMHead, Params, _attn_pdefs,
                                           remat_call)


def _mlp_pdefs(cfg: ArchConfig, nl: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w_in": PDef((nl, D, F), "p_mlp_in", stacked=1),
            "w_out": PDef((nl, F, D), "p_mlp_out", stacked=1)}


def encdec_pdefs(cfg: ArchConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_padded
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    return {
        "embed": PDef((V, D), "p_embed", scale=0.02),
        "unembed": PDef((V, D), "p_embed", scale=1.0 / math.sqrt(D)),
        "final_norm": PDef((D,), "p_norm", init="zeros"),
        "enc_final_norm": PDef((D,), "p_norm", init="zeros"),
        "encoder": {
            "ln1": PDef((ne, D), "p_norm", init="zeros", stacked=1),
            "ln2": PDef((ne, D), "p_norm", init="zeros", stacked=1),
            "attn": _attn_pdefs(cfg, ne),
            "mlp": _mlp_pdefs(cfg, ne),
        },
        "decoder": {
            "ln1": PDef((nd, D), "p_norm", init="zeros", stacked=1),
            "ln2": PDef((nd, D), "p_norm", init="zeros", stacked=1),
            "ln3": PDef((nd, D), "p_norm", init="zeros", stacked=1),
            "self_attn": _attn_pdefs(cfg, nd),
            "cross_attn": _attn_pdefs(cfg, nd),
            "mlp": _mlp_pdefs(cfg, nd),
        },
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class EncDecLM(LMHead):
    """Encoder layers (``ln1, attn, ln2, mlp``) and their final norm, then
    decoder layers (``ln1, self_attn, ln2, cross_attn, ln3, mlp``), final
    norm and unembedding."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, tree)
        self.enc_final_norm = nn.Parameter(tree["enc_final_norm"],
                                           requires_grad=False)
        self.encoder = nn.ModuleList(
            Params(layer(tree["encoder"], i))
            for i in range(cfg.n_enc_layers))
        self.decoder = nn.ModuleList(
            Params(layer(tree["decoder"], i)) for i in range(cfg.n_layers))

    def forward(self, tokens, frames, last_only: bool = False):
        return encdec_forward(self, self.cfg, tokens, frames,
                              last_only=last_only)


def build_model(cfg: ArchConfig, tree: dict) -> EncDecLM:
    """The model holding ``tree`` (the JAX package's parameter tree, of
    tensors), its encoder and decoder stacks unstacked into ModuleLists as
    views.  Raises on a missing or extra key or a shape that differs from
    :func:`encdec_pdefs`."""
    check_tree(cfg.arch_id, encdec_pdefs(cfg), tree)
    return EncDecLM(cfg, tree)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def encode(model: EncDecLM, cfg: ArchConfig, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> encoder memory (B, F, D);
    ``remat`` recomputes each layer in the backward pass."""
    x = frames
    positions = torch.arange(x.shape[1], device=x.device)
    body = remat_call(_encoder_layer, remat, model)
    for lp in model.encoder:
        x = body(cfg, lp, x, positions)
    return ll.rmsnorm(x, model.enc_final_norm, cfg.norm_eps)


def _encoder_layer(cfg, lp, x, positions):
    """Bidirectional attention over the frames x (B, F, D), then the GELU
    MLP."""
    attn = gather_fsdp(lp["attn"], ATTN_LOGICAL)
    mlp = gather_fsdp(lp["mlp"], MLP_LOGICAL)
    h = ll.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, _ = ll.attention(attn, h, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv_heads, hd=cfg.hd,
                        rope_theta=cfg.rope_theta, positions=positions,
                        causal=False, kv_chunk=min(1024, x.shape[1]))
    x = x + y
    h = ll.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + ll.gelu_mlp(mlp, h)


def _decoder_layer(cfg, lp, x, positions, memory, self_cache=None,
                   cross_cache=None, cache_pos=None, kv_chunk=1024):
    """Returns (x out, the self-attention cache)."""
    self_attn = gather_fsdp(lp["self_attn"], ATTN_LOGICAL)
    cross_attn = gather_fsdp(lp["cross_attn"], ATTN_LOGICAL)
    mlp = gather_fsdp(lp["mlp"], MLP_LOGICAL)
    h = ll.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, new_self = ll.attention(self_attn, h, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv_heads, hd=cfg.hd,
                               rope_theta=cfg.rope_theta, positions=positions,
                               cache=self_cache, cache_pos=cache_pos,
                               kv_chunk=kv_chunk)
    x = x + y
    h = ll.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, _ = ll.attention(cross_attn, h, n_heads=cfg.n_heads,
                        n_kv=cfg.n_kv_heads, hd=cfg.hd,
                        rope_theta=cfg.rope_theta, positions=positions,
                        cache=cross_cache, xkv=memory, use_rope=False,
                        causal=False, cross_cached=cross_cache is not None,
                        kv_chunk=1024)
    x = x + y
    h = ll.rmsnorm(x, lp["ln3"], cfg.norm_eps)
    return x + ll.gelu_mlp(mlp, h), new_self


def encdec_forward(model: EncDecLM, cfg: ArchConfig, tokens: torch.Tensor,
                   frames: torch.Tensor, remat: bool = True,
                   last_only: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward (training, prefill): (logits, aux loss 0);
    ``remat`` recomputes each encoder and decoder layer in the backward
    pass."""
    memory = encode(model, cfg, frames, remat=remat)
    x = ll.embed(model.embed, tokens)
    L = x.shape[1]
    positions = torch.arange(L, device=x.device)
    kv_chunk = 1024 if L >= 1024 else L
    body = remat_call(_decoder_layer, remat, model)
    for lp in model.decoder:
        x, _ = body(cfg, lp, x, positions, memory, kv_chunk=kv_chunk)
        x = shard_seq(x)
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return (ll.unembed(model.unembed, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def encdec_precompute_cross(model: EncDecLM, cfg: ArchConfig,
                            memory: torch.Tensor) -> dict:
    """Project encoder memory to per-layer cross K/V once per request:
    {"cross_k", "cross_v"}, each (nd, B, F, KV, hd)."""
    ks, vs = [], []
    for lp in model.decoder:
        ca = lp["cross_attn"]
        ks.append(torch.einsum("btd,dhk->bthk", memory, ca["wk"]))
        vs.append(torch.einsum("btd,dhk->bthk", memory, ca["wv"]))
    return {"cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def encdec_decode_step(model: EncDecLM, cfg: ArchConfig, cache: dict,
                       tokens: torch.Tensor, pos
                       ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  cache: self_k/self_v (nd, B, S, KV, hd), updated in
    place, and cross_k/cross_v (nd, B, F, KV, hd) precomputed; returns
    (logits, the cache)."""
    x = ll.embed(model.embed, tokens)
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=x.device)
    for i, lp in enumerate(model.decoder):
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        x, _ = _decoder_layer(
            cfg, lp, x, positions, memory=None,
            self_cache={"k": sk, "v": sv},
            cross_cache={"k": cache["cross_k"][i], "v": cache["cross_v"][i]},
            cache_pos=pos, kv_chunk=min(2048, sk.shape[1]))
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return ll.unembed(model.unembed, x), cache
