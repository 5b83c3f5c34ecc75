"""Decoder-only model families: dense, MoE, VLM (stub frontend), pure SSM
(Mamba-2) and the Zamba-style hybrid, as the JAX package's
``models/transformer.py`` defines them.

Parameters are declared with the JAX package's tree (:func:`decoder_pdefs`,
stacked per layer) and held in ``nn.Module``s: each layer is a module of
its own and the stacks are ``nn.ModuleList``s, walked by Python loops where
the JAX package scans (:func:`build_model` unstacks a tree; a MoE layer's
expert stacks (E, ...) stay whole).  Parameters do not require gradients
until the caller turns them on (``model.requires_grad_(True)``, as the
trainer does); with grad enabled, ``remat=True`` recomputes each layer
body in the backward pass (:func:`remat_call`, the reference's
``jax.checkpoint``).  The encoder-decoder family is ``models/encdec.py``.

Window dispatch.  The JAX package scans the dense stack over
:func:`layer_windows`' array, so every dense, MoE and VLM layer sees a
traced window and takes its jnp attention path, never its Pallas kernel.
Here the windows are Python ints: a layer of window 0 (every layer but
gemma2's local ones) meets the kernel's conditions and, at ``L % 128 ==
0``, goes to flash attention (K3); gemma2's local layers take the plain
chunk scan, as in the JAX package.  Both compute the same function.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ATTN_LOGICAL, MLP_LOGICAL,
                                              MOE_LOGICAL, SSM_LOGICAL,
                                              gather_fsdp, shard_seq)
from repro_torch.models import layers as ll
from repro_torch.models.moe import moe_block
from repro_torch.models.params import PDef, check_tree, layer
from repro_torch.models.ssm import mamba_block, mamba_dims

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
def _attn_pdefs(cfg: ArchConfig, nl: int) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": PDef((nl, D, H, hd), "p_attn_qkv", stacked=1),
        "wk": PDef((nl, D, KV, hd), "p_attn_qkv", stacked=1),
        "wv": PDef((nl, D, KV, hd), "p_attn_qkv", stacked=1),
        "wo": PDef((nl, H, hd, D), "p_attn_o", stacked=1,
                   scale=1.0 / math.sqrt(H * hd)),
    }


def _mlp_pdefs(cfg: ArchConfig, nl: int, d_ff: int) -> dict:
    D = cfg.d_model
    return {
        "w_in": PDef((nl, D, d_ff), "p_mlp_in", stacked=1),
        "w_out": PDef((nl, d_ff, D), "p_mlp_out", stacked=1),
        "w_gate": PDef((nl, D, d_ff), "p_mlp_in", stacked=1),
    }


def _moe_pdefs(cfg: ArchConfig, nl: int) -> dict:
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": PDef((nl, D, E), "p_router", stacked=1),
        "w_gate": PDef((nl, E, D, F), "p_expert_in", stacked=2),
        "w_in": PDef((nl, E, D, F), "p_expert_in", stacked=2),
        "w_out": PDef((nl, E, F, D), "p_expert_out", stacked=2),
    }


def _mamba_pdefs(cfg: ArchConfig, stack: Tuple[int, ...]) -> dict:
    D = cfg.d_model
    d_inner, H, conv_dim = mamba_dims(D, cfg.ssm_expand, cfg.ssm_head_dim,
                                      cfg.ssm_state)
    proj = 2 * d_inner + 2 * cfg.ssm_state + H
    ns = len(stack)
    return {
        "ln": PDef(stack + (D,), "p_norm", init="zeros", stacked=ns),
        "w_in": PDef(stack + (D, proj), "p_ssm_in", stacked=ns),
        "w_out": PDef(stack + (d_inner, D), "p_ssm_out", stacked=ns),
        "conv_w": PDef(stack + (cfg.ssm_conv, conv_dim), "p_conv",
                       stacked=ns, scale=0.5),
        "dt_bias": PDef(stack + (H,), "p_ssm_small", init="zeros", stacked=ns),
        "A_log": PDef(stack + (H,), "p_ssm_small", init="zeros", stacked=ns),
        "D": PDef(stack + (H,), "p_ssm_small", init="ones", stacked=ns),
    }


def decoder_pdefs(cfg: ArchConfig) -> dict:
    """The JAX package's parameter tree of a decoder-only family."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch_id}: the {cfg.family!r} family is not "
                         f"decoder-only (models/encdec.py)")
    D, V, nl = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    p: dict = {
        "embed": PDef((V, D), "p_embed", scale=0.02),
        "unembed": PDef((V, D), "p_embed", scale=1.0 / math.sqrt(D)),
        "final_norm": PDef((D,), "p_norm", init="zeros"),
    }
    if cfg.family == "vlm":
        p["patch_proj"] = PDef((D, D), None)  # stub-frontend adapter
    if cfg.family == "ssm":
        p["layers"] = _mamba_pdefs(cfg, (nl,))
        return p
    if cfg.family in ("dense", "moe", "vlm"):
        lay = {
            "ln1": PDef((nl, D), "p_norm", init="zeros", stacked=1),
            "ln2": PDef((nl, D), "p_norm", init="zeros", stacked=1),
            "attn": _attn_pdefs(cfg, nl),
        }
        if cfg.family == "moe":
            lay["moe"] = _moe_pdefs(cfg, nl)
            if cfg.shared_expert_d_ff:
                lay["mlp"] = _mlp_pdefs(cfg, nl, cfg.shared_expert_d_ff)
        else:
            lay["mlp"] = _mlp_pdefs(cfg, nl, cfg.d_ff)
        p["layers"] = lay
        return p
    n_super = nl // cfg.attn_every
    per = cfg.attn_every
    tail = nl - n_super * per
    p["shared_attn"] = {
        "ln1": PDef((D,), "p_norm", init="zeros"),
        "attn": {k: PDef(v.shape[1:], v.logical, scale=v.scale)
                 for k, v in _attn_pdefs(cfg, 1).items()},
        "ln2": PDef((D,), "p_norm", init="zeros"),
        "mlp": {k: PDef(v.shape[1:], v.logical, scale=v.scale)
                for k, v in _mlp_pdefs(cfg, 1, cfg.d_ff).items()},
    }
    p["mamba_super"] = _mamba_pdefs(cfg, (n_super, per))
    if tail:
        p["mamba_tail"] = _mamba_pdefs(cfg, (tail,))
    return p


def layer_windows(cfg: ArchConfig) -> List[int]:
    """Per-layer window sizes (0 = global): gemma2 alternates local
    (``window``) and global layers."""
    if cfg.alternate_local_global:
        return [cfg.window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class Params(nn.Module):
    """A module whose parameters (and sub-modules) are read by name,
    ``p["w_in"]``, as the layer functions read the JAX package's dicts."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)


class Mamba2Layer(Params):
    """One pre-norm Mamba-2 layer with its residual (``_mamba_apply``)."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__(tensors)
        self.cfg = cfg

    def forward(self, x, cache: Optional[dict] = None):
        return _mamba_apply(self.cfg, self, x, cache)


class SharedAttentionBlock(Params):
    """Zamba2's shared attention + MLP block (``_shared_attn_apply``)."""

    def __init__(self, cfg: ArchConfig, tensors: dict):
        super().__init__(tensors)
        self.cfg = cfg

    def forward(self, x, positions, cache=None, cache_pos=None,
                kv_chunk: int = 1024):
        return _shared_attn_apply(self.cfg, self, x, positions, cache,
                                  cache_pos, kv_chunk)


class DenseLayer(Params):
    """One pre-norm attention + MLP (or MoE) layer with its residuals
    (``_attn_mlp_layer``)."""

    def __init__(self, cfg: ArchConfig, tensors: dict, window: int):
        super().__init__(tensors)
        self.cfg = cfg
        self.window = window

    def forward(self, x, positions, cache=None, cache_pos=None,
                kv_chunk: int = 1024):
        return _attn_mlp_layer(self.cfg, self, x, positions, self.window,
                               cache, cache_pos, kv_chunk)


class LMHead(nn.Module):
    """Embedding, final norm and unembedding, the parameters every family
    has outside its layers."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        for k in ("embed", "unembed", "final_norm"):
            self.register_parameter(k, nn.Parameter(tree[k],
                                                    requires_grad=False))


class DenseLM(LMHead):
    """The dense, moe and vlm families: embedding (after vlm's projected
    patch prefix), attention + MLP/MoE layers, final norm, unembedding."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, tree)
        if cfg.family == "vlm":
            self.patch_proj = nn.Parameter(tree["patch_proj"],
                                           requires_grad=False)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, layer(tree["layers"], i), w)
            for i, w in enumerate(layer_windows(cfg)))

    def forward(self, tokens, patches=None, last_only: bool = False):
        return dense_forward(self, self.cfg, tokens, patches=patches,
                             last_only=last_only)


class Mamba2LM(LMHead):
    """The ``ssm`` family: embedding, Mamba-2 layers, final norm,
    unembedding."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, tree)
        self.layers = nn.ModuleList(
            Mamba2Layer(cfg, layer(tree["layers"], i))
            for i in range(cfg.n_layers))

    def forward(self, tokens, last_only: bool = False):
        return ssm_forward(self, self.cfg, tokens, last_only=last_only)


class Zamba2LM(LMHead):
    """The ``hybrid`` family: the shared attention block before every
    ``attn_every`` Mamba-2 layers, then a tail of Mamba-2 layers."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__(cfg, tree)
        self.shared_attn = SharedAttentionBlock(cfg, tree["shared_attn"])
        sup = tree["mamba_super"]
        n_super = cfg.n_layers // cfg.attn_every
        self.mamba_super = nn.ModuleList(
            nn.ModuleList(Mamba2Layer(cfg, layer(sup, s, j))
                          for j in range(cfg.attn_every))
            for s in range(n_super))
        tail = tree.get("mamba_tail", {})
        n_tail = cfg.n_layers - n_super * cfg.attn_every
        self.mamba_tail = nn.ModuleList(
            Mamba2Layer(cfg, layer(tail, i)) for i in range(n_tail))

    def forward(self, tokens, last_only: bool = False):
        return hybrid_forward(self, self.cfg, tokens, last_only=last_only)


def build_model(cfg: ArchConfig, tree: dict) -> nn.Module:
    """The model holding ``tree`` (the JAX package's parameter tree, of
    tensors), its stacked layers unstacked into ModuleLists as views.
    Raises on a missing or extra key or a shape that differs from
    :func:`decoder_pdefs`."""
    check_tree(cfg.arch_id, decoder_pdefs(cfg), tree)
    if cfg.family == "ssm":
        return Mamba2LM(cfg, tree)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, tree)
    return DenseLM(cfg, tree)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def remat_call(fn, remat: bool, model: nn.Module):
    """``fn``, recomputed in the backward pass instead of keeping its
    activations (``torch.utils.checkpoint``, non-reentrant) when ``remat``,
    grad is enabled and a parameter of ``model`` requires grad; ``fn``
    itself otherwise (a serving forward runs as it did)."""
    if remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in model.parameters()):
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def _zero(device=None):
    return torch.zeros((), dtype=torch.float32, device=device)


# -- dense / moe / vlm ----------------------------------------------------
def _attn_mlp_layer(cfg: ArchConfig, lp, x, positions, window: int,
                    cache=None, cache_pos=None, kv_chunk: int = 1024):
    """Returns (x out, the layer's MoE aux loss or 0, the cache)."""
    attn = gather_fsdp(lp["attn"], ATTN_LOGICAL)
    mlp = (gather_fsdp(lp["mlp"], MLP_LOGICAL)
           if cfg.family != "moe" or cfg.shared_expert_d_ff else None)
    h = ll.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, new_cache = ll.attention(
        attn, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope_theta=cfg.rope_theta, positions=positions, cache=cache,
        cache_pos=cache_pos, window=window, softcap=cfg.attn_softcap,
        kv_chunk=kv_chunk)
    x = x + y
    h = ll.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    aux = _zero(x.device)
    if cfg.family == "moe":
        y, aux = moe_block(gather_fsdp(lp["moe"], MOE_LOGICAL), h,
                           n_experts=cfg.n_experts, top_k=cfg.top_k)
        if cfg.shared_expert_d_ff:
            y = y + ll.swiglu(mlp, h)
    else:
        y = ll.swiglu(mlp, h)
    return x + y, aux, new_cache


def dense_forward(model: DenseLM, cfg: ArchConfig, tokens: torch.Tensor, *,
                  patches: Optional[torch.Tensor] = None, remat: bool = True,
                  last_only: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward for dense / moe / vlm (vlm: the projected
    ``patches`` (B, P, D) before the tokens).  Returns (logits, the mean of
    the layers' aux losses); ``remat`` recomputes each layer in the
    backward pass."""
    x = ll.embed(model.embed, tokens)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError(f"{cfg.arch_id}: the vlm forward needs patches")
        pe = patches @ model.patch_proj
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    L = x.shape[1]
    positions = torch.arange(L, device=x.device)
    kv_chunk = 1024 if L >= 1024 else L
    auxs = []
    body = remat_call(_attn_mlp_layer, remat, model)
    for lp in model.layers:
        x, aux, _ = body(cfg, lp, x, positions, lp.window, kv_chunk=kv_chunk)
        x = shard_seq(x)
        auxs.append(aux)
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = ll.unembed(model.unembed, x, cfg.logit_softcap)
    return logits, torch.stack(auxs).mean()


def dense_decode_step(model: DenseLM, cfg: ArchConfig, cache: dict,
                      tokens: torch.Tensor, pos) -> Tuple[torch.Tensor, dict]:
    """One decode step.  cache {"k", "v"}: (nl, B, S, KV, hd), updated in
    place and returned; tokens (B, 1); pos an int shared by the batch."""
    x = ll.embed(model.embed, tokens)
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=x.device)
    for i, lp in enumerate(model.layers):
        ck, cv = cache["k"][i], cache["v"][i]
        x, _, _ = _attn_mlp_layer(cfg, lp, x, positions, lp.window,
                                  cache={"k": ck, "v": cv}, cache_pos=pos,
                                  kv_chunk=min(2048, ck.shape[1]))
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return ll.unembed(model.unembed, x, cfg.logit_softcap), cache


# -- pure SSM -------------------------------------------------------------
def ssm_forward(model: Mamba2LM, cfg: ArchConfig, tokens: torch.Tensor, *,
                remat: bool = True, last_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward; ``remat`` recomputes each layer in the
    backward pass."""
    x = ll.embed(model.embed, tokens)
    body = remat_call(_mamba_apply, remat, model)
    for lp in model.layers:
        x, _ = body(cfg, lp, x)
        x = shard_seq(x)
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return ll.unembed(model.unembed, x), _zero()


def ssm_decode_step(model: Mamba2LM, cfg: ArchConfig, cache: dict,
                    tokens: torch.Tensor, pos) -> Tuple[torch.Tensor, dict]:
    """One decode step; ``cache`` is updated in place and returned."""
    x = ll.embed(model.embed, tokens)
    for i, lp in enumerate(model.layers):
        x, _ = _mamba_apply(cfg, lp, x, {"conv": cache["conv"][i],
                                         "state": cache["state"][i]})
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return ll.unembed(model.unembed, x), cache


def _shared_attn_apply(cfg, sp, x, positions, cache=None, cache_pos=None,
                       kv_chunk=1024):
    h = ll.rmsnorm(x, sp["ln1"], cfg.norm_eps)
    y, new_cache = ll.attention(
        sp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope_theta=cfg.rope_theta, positions=positions, cache=cache,
        cache_pos=cache_pos, kv_chunk=kv_chunk)
    x = x + y
    h = ll.rmsnorm(x, sp["ln2"], cfg.norm_eps)
    return x + ll.swiglu(sp["mlp"], h), new_cache


def _mamba_apply(cfg, lp, x, cache=None):
    lp = gather_fsdp(lp, SSM_LOGICAL)
    h = ll.rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, nc = mamba_block(lp, h, head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                        expand=cfg.ssm_expand, conv_k=cfg.ssm_conv,
                        cache=cache)
    return x + y, nc


def hybrid_forward(model: Zamba2LM, cfg: ArchConfig, tokens: torch.Tensor, *,
                   remat: bool = True, last_only: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward; ``remat`` recomputes each super-block (the
    shared attention block and its Mamba-2 layers) in the backward pass,
    as the reference's checkpointed scan body; the tail is not
    recomputed."""
    x = ll.embed(model.embed, tokens)
    L = x.shape[1]
    positions = torch.arange(L, device=x.device)
    kv_chunk = 1024 if L >= 1024 else L

    def super_body(x, blocks):
        x, _ = _shared_attn_apply(cfg, model.shared_attn, x, positions,
                                  kv_chunk=kv_chunk)
        for lp in blocks:
            x, _ = _mamba_apply(cfg, lp, x)
        return shard_seq(x)

    body = remat_call(super_body, remat, model)
    for blocks in model.mamba_super:
        x = body(x, blocks)
    for lp in model.mamba_tail:
        x, _ = _mamba_apply(cfg, lp, x)
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    return ll.unembed(model.unembed, x), _zero()


def hybrid_decode_step(model: Zamba2LM, cfg: ArchConfig, cache: dict,
                       tokens: torch.Tensor, pos
                       ) -> Tuple[torch.Tensor, dict]:
    """One decode step; ``cache`` is updated in place and returned."""
    x = ll.embed(model.embed, tokens)
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=x.device)
    for s, blocks in enumerate(model.mamba_super):
        ck, cv = cache["attn_k"][s], cache["attn_v"][s]
        x, _ = _shared_attn_apply(cfg, model.shared_attn, x, positions,
                                  cache={"k": ck, "v": cv}, cache_pos=pos,
                                  kv_chunk=min(2048, ck.shape[1]))
        for j, lp in enumerate(blocks):
            x, _ = _mamba_apply(cfg, lp, x,
                                {"conv": cache["super_conv"][s, j],
                                 "state": cache["super_state"][s, j]})
    for i, lp in enumerate(model.mamba_tail):
        x, _ = _mamba_apply(cfg, lp, x, {"conv": cache["tail_conv"][i],
                                         "state": cache["tail_state"][i]})
    x = ll.rmsnorm(x, model.final_norm, cfg.norm_eps)
    return ll.unembed(model.unembed, x), cache
