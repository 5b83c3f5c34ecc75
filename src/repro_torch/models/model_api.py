"""Model API over every family (dense, moe, vlm, audio encoder-decoder,
ssm, hybrid), one entry point per lifecycle stage as in the JAX package's
``models/model_api.py``:

* :func:`pdefs` / :func:`init_params` / :func:`param_shapes` /
  :func:`build_model` / :func:`n_params` / :func:`n_active_params` — the
  parameter tree (declarative ``PDef``), the model holding it, and its
  shapes as :class:`TensorSpec`s;
* :func:`forward` — full-sequence forward (training, prefill), with the
  modality stubs' ``patches`` (vlm) and ``frames`` (audio);
  ``logits_last_only=True`` is the serving prefill;
* :func:`loss_fn` — next-token cross-entropy (+ MoE aux loss);
* :func:`cache_shapes` / :func:`init_cache` — the decode state;
* :func:`decode_step` — one token against the cache (updated in place);
* :func:`batch_shapes` / :func:`make_batch` — one shape cell's inputs, as
  specs or drawn at random.

Every entry point that makes tensors runs on the card unless the caller
passes ``device="cpu"``.  Parameters do not require gradients until the
caller turns them on (``model.requires_grad_(True)``, as the trainer
does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import get_ctx, shard
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.params import leaves, materialize
from repro_torch.models.params import n_params as _n_params
from repro_torch.models.ssm import mamba_dims


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not yet made (the JAX package's
    ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def pdefs(cfg: ArchConfig) -> dict:
    if cfg.is_encdec:
        return ed.encdec_pdefs(cfg)
    return tf.decoder_pdefs(cfg)


def build_model(cfg: ArchConfig, tree: dict) -> nn.Module:
    """The model of ``cfg`` holding ``tree`` (a tree of tensors with the
    shapes of :func:`pdefs`)."""
    if cfg.is_encdec:
        return ed.build_model(cfg, tree)
    return tf.build_model(cfg, tree)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """The model with parameters made from ``generator`` (see
    :func:`~repro_torch.models.params.materialize`) on ``device``."""
    model = build_model(cfg, materialize(pdefs(cfg), generator, device))
    return model if dtype == torch.float32 else model.to(dtype)


def param_shapes(cfg: ArchConfig) -> dict:
    """The reference's parameter tree (stacked shapes) as
    :class:`TensorSpec`s."""
    out: dict = {}
    for path, d in leaves(pdefs(cfg)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = TensorSpec(tuple(d.shape), d.dtype)
    return out


def n_params(cfg: ArchConfig) -> int:
    return _n_params(pdefs(cfg))


def n_active_params(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = n_params(cfg)
    if cfg.family != "moe" or cfg.n_experts == 0:
        return total
    expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.n_layers  # gate+in+out
    return total - expert * cfg.n_experts + expert * cfg.top_k


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(params: nn.Module, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            logits_last_only: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, L, V) float32, aux_loss scalar).  For vlm the
    logits cover only the text positions (the patch prefix stripped).
    ``logits_last_only`` (serving prefill) slices the hidden state to the
    final position before the unembedding.  ``remat``: with grad enabled,
    each layer (a hybrid's super-block) is recomputed in the backward pass
    instead of keeping its activations, as the reference's
    ``jax.checkpoint``."""
    if cfg.is_encdec:
        return ed.encdec_forward(params, cfg, batch["tokens"],
                                 batch["frames"], remat=remat,
                                 last_only=logits_last_only)
    if cfg.family == "ssm":
        return tf.ssm_forward(params, cfg, batch["tokens"], remat=remat,
                              last_only=logits_last_only)
    if cfg.family == "hybrid":
        return tf.hybrid_forward(params, cfg, batch["tokens"], remat=remat,
                                 last_only=logits_last_only)
    patches = batch.get("patches")
    logits, aux = tf.dense_forward(params, cfg, batch["tokens"],
                                   patches=patches, remat=remat,
                                   last_only=logits_last_only)
    if (cfg.family == "vlm" and patches is not None
            and not logits_last_only):
        logits = logits[:, patches.shape[1]:]
    return logits, aux


def loss_fn(params: nn.Module, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE over ``labels`` (already shifted by the data
    pipeline), the padded vocabulary's columns masked out of the partition
    function with -1e30, plus ``aux_weight`` times the MoE aux loss.
    Returns (loss, {"loss", "ce", "aux"})."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"].long()
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab:
        pad_mask = torch.arange(cfg.vocab_padded,
                                device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad_mask, -1e30)
    if get_ctx() is None:
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = torch.gather(logits, -1, labels[..., None])
    else:
        # Vocab-sharded logits (a DTensor): DTensor's logsumexp gathers the
        # whole vocabulary, and the gather's backward builds a replicated
        # zeros of the logits' full shape.  The same functions from
        # reductions over the shards: the max-shifted sum of exps, and a
        # masked sum with one nonzero term a row (exact).
        mx = logits.amax(-1, keepdim=True).detach()
        logz = mx + torch.log(torch.exp(logits - mx).sum(-1, keepdim=True))
        hit = shard(torch.arange(logits.shape[-1], device=logits.device)
                    == labels[..., None], "logits")
        gold = shard(torch.where(hit, logits, 0.0), "logits").sum(
            -1, keepdim=True)
    # (B, L, 1) throughout: a DTensor's vocab-sharded gather is a masked
    # partial sum, which a view of it may not drop a dim of; the constraint
    # keeps the mean's gradient batch-sharded
    ce = shard(logz - gold, "act_btd").mean()
    loss = ce + aux_weight * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------
def cache_shapes(cfg: ArchConfig, B: int, S: int,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """The decode-state tree as :class:`TensorSpec`s (SSM states are always
    float32)."""
    nl, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if cfg.is_encdec:
        F = cfg.enc_frames
        return {"self_k": TensorSpec((nl, B, S, KV, hd), dtype),
                "self_v": TensorSpec((nl, B, S, KV, hd), dtype),
                "cross_k": TensorSpec((nl, B, F, KV, hd), dtype),
                "cross_v": TensorSpec((nl, B, F, KV, hd), dtype)}
    if cfg.family not in ("ssm", "hybrid"):
        return {"k": TensorSpec((nl, B, S, KV, hd), dtype),
                "v": TensorSpec((nl, B, S, KV, hd), dtype)}
    d_inner, H, conv_dim = mamba_dims(cfg.d_model, cfg.ssm_expand,
                                      cfg.ssm_head_dim, cfg.ssm_state)
    conv = (B, cfg.ssm_conv - 1, conv_dim)
    state = (B, H, cfg.ssm_head_dim, cfg.ssm_state)
    f32 = torch.float32
    if cfg.family == "ssm":
        return {"conv": TensorSpec((nl,) + conv, dtype),
                "state": TensorSpec((nl,) + state, f32)}
    n_super = nl // cfg.attn_every
    per = cfg.attn_every
    tail = nl - n_super * per
    tree = {
        "attn_k": TensorSpec((n_super, B, S, KV, hd), dtype),
        "attn_v": TensorSpec((n_super, B, S, KV, hd), dtype),
        "super_conv": TensorSpec((n_super, per) + conv, dtype),
        "super_state": TensorSpec((n_super, per) + state, f32),
    }
    if tail:
        tree["tail_conv"] = TensorSpec((tail,) + conv, dtype)
        tree["tail_state"] = TensorSpec((tail,) + state, f32)
    return tree


def init_cache(cfg: ArchConfig, B: int, S: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_shapes(cfg, B, S, dtype).items()}


def decode_step(params: nn.Module, cfg: ArchConfig, cache: dict,
                tokens: torch.Tensor, pos) -> Tuple[torch.Tensor, dict]:
    """One serve step: tokens (B, 1), pos an int (shared by the batch) ->
    (logits (B, 1, V), the cache, updated in place)."""
    if cfg.is_encdec:
        return ed.encdec_decode_step(params, cfg, cache, tokens, pos)
    if cfg.family == "ssm":
        return tf.ssm_decode_step(params, cfg, cache, tokens, pos)
    if cfg.family == "hybrid":
        return tf.hybrid_decode_step(params, cfg, cache, tokens, pos)
    return tf.dense_decode_step(params, cfg, cache, tokens, pos)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------
def batch_shapes(cfg: ArchConfig, cell: ShapeCell
                 ) -> Dict[str, TensorSpec]:
    """Model inputs for one cell, in the reference's key order: kind
    "decode" gives tokens (B, 1) and pos (); "train" tokens and labels
    (B, L); "prefill" tokens; then vlm's ``patches`` (B, n_patches, D) and
    audio's ``frames`` (B, enc_frames, D) in float32."""
    B, L = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind == "decode":
        return {"tokens": TensorSpec((B, 1), i32),
                "pos": TensorSpec((), i32)}
    spec = {"tokens": TensorSpec((B, L), i32)}
    if cell.kind == "train":
        spec["labels"] = TensorSpec((B, L), i32)
    if cfg.family == "vlm":
        spec["patches"] = TensorSpec((B, cfg.n_patches, cfg.d_model),
                                     torch.float32)
    if cfg.is_encdec:
        spec["frames"] = TensorSpec((B, cfg.enc_frames, cfg.d_model),
                                    torch.float32)
    return spec


def make_batch(cfg: ArchConfig, cell: ShapeCell, rng: np.random.Generator,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A random batch of one cell, drawn with numpy in the order of
    :func:`batch_shapes`, so that one seed gives both packages the same
    batch: tokens and labels below ``vocab`` (int64), ``pos`` 0, and the
    float inputs standard normal float32."""
    device = resolve_device(device)
    out = {}
    for k, s in batch_shapes(cfg, cell).items():
        if s.dtype == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") else 1
            a = np.asarray(rng.integers(0, hi, size=s.shape, dtype=np.int64))
        else:
            a = rng.standard_normal(s.shape).astype(np.float32)
        out[k] = torch.from_numpy(a).to(device)
    return out
