"""Production mesh construction and per-cell sharding assignment, as the
JAX package's ``launch/mesh.py`` states them.

``make_production_mesh`` is a FUNCTION (not a module constant), so
importing this module never touches process-group state: it needs a
default process group of 256 (single pod) or 512 ranks, which only the dry
run (``launch/dryrun.py``, placeholder ranks) or a real launch sets up.
The policy functions read only the mesh's axis names and extents, so they
also take a stand-in with ``shape`` (a mapping) and ``axis_names``.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed.sharding import (NamedSharding, P, ShardingCtx,
                                              axis_names, axis_sizes,
                                              sanitize_spec)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over the default process
    group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_ctx(mesh, cfg: ArchConfig, cell: ShapeCell, *,
             fsdp: Optional[bool] = None,
             seq_parallel: Optional[bool] = None) -> ShardingCtx:
    """Sharding policy for one (arch x shape) cell.

    * FSDP on the ``data`` axis for training; TP-only for serving.
    * Sequence parallelism for train/prefill when the sequence divides the
      model axis (activation carry sharded on seq between layers).
    * ``long_500k`` (B=1): batch axes cannot shard — the KV/state trees
      shard on ``model`` only, batch replicated.
    """
    names = axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    if fsdp is None:
        fsdp = cell.kind == "train"
    if seq_parallel is None:
        seq_parallel = cell.kind in ("train", "prefill")
    n_model = axis_sizes(mesh)["model"]
    if cfg.n_kv_heads and cfg.n_kv_heads % n_model == 0:
        kv_axis = "heads"
    elif cfg.n_heads and cfg.hd % n_model == 0:
        kv_axis = "hd"
    else:
        kv_axis = "none"
    if cfg.n_heads and cfg.n_heads % n_model == 0:
        attn_q_axis = "heads"
    elif cfg.n_heads and cell.kind in ("train", "prefill"):
        # Heads don't divide the axis: shard the query sequence instead
        # (KV replicated per layer, scores local).
        attn_q_axis = "seq"
        kv_axis = "none"
    elif cfg.n_heads and cfg.hd % n_model == 0:
        attn_q_axis = "hd"
    else:
        attn_q_axis = "none"
    # Serving a large MoE: shard the expert hidden dim over "data" (EP x
    # TP2): no per-step weight all-gather, only small activation sums.
    expert_tp2 = (cfg.family == "moe" and cell.kind != "train")
    return ShardingCtx(mesh=mesh, batch_axes=batch_axes, model_axis="model",
                       fsdp=fsdp, seq_parallel=seq_parallel, kv_axis=kv_axis,
                       attn_q_axis=attn_q_axis, expert_tp2=expert_tp2)


def _batch_divisible(cell: ShapeCell, mesh) -> bool:
    sizes = axis_sizes(mesh)
    n_batch = 1
    for a in ("pod", "data"):
        if a in sizes:
            n_batch *= sizes[a]
    return cell.global_batch % n_batch == 0


def input_shardings(ctx: ShardingCtx, cfg: ArchConfig, cell: ShapeCell
                    ) -> Dict[str, NamedSharding]:
    """Shardings for every entry of ``model_api.batch_shapes``."""
    mesh = ctx.mesh
    b = ctx.batch_axes if _batch_divisible(cell, mesh) else None

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    if cell.kind == "decode":
        return {"tokens": ns(b, None), "pos": ns()}
    out = {"tokens": ns(b, None)}
    if cell.kind == "train":
        out["labels"] = ns(b, None)
    if cfg.family == "vlm":
        out["patches"] = ns(b, None, None)
    if cfg.is_encdec:
        out["frames"] = ns(b, None, None)
    return out


def cache_shardings(ctx: ShardingCtx, cfg: ArchConfig, cell: ShapeCell
                    ) -> dict:
    """Shardings for the decode cache tree (``model_api.cache_shapes``).

    KV heads / SSM heads shard on ``model``; batch on the batch axes when
    divisible (long_500k B=1 -> replicated batch, model-only sharding)."""
    from repro_torch.models import model_api
    mesh = ctx.mesh
    m = ctx.model_axis
    n_model = axis_sizes(mesh)[m]
    b = ctx.batch_axes if _batch_divisible(cell, mesh) else None
    shapes = model_api.cache_shapes(cfg, cell.global_batch, cell.seq_len)

    def make(tree):
        """Sanitize each spec against the actual cache leaf shape."""
        return {k: NamedSharding(mesh, sanitize_spec(shapes[k].shape, s,
                                                     mesh))
                for k, s in tree.items()}

    # KV cache model-axis placement: shard KV heads when they divide the
    # axis; otherwise shard head_dim (a sub-head split), so the dominant
    # decode operand is never replicated.
    kv_ok = cfg.n_kv_heads % n_model == 0 if cfg.n_kv_heads else False
    hd_ok = cfg.hd % n_model == 0 if cfg.n_heads else False
    kv = m if kv_ok else None
    hd = m if (not kv_ok and hd_ok) else None
    if cfg.is_encdec:
        return make({"self_k": P(None, b, None, kv, hd),
                     "self_v": P(None, b, None, kv, hd),
                     "cross_k": P(None, b, None, kv, hd),
                     "cross_v": P(None, b, None, kv, hd)})
    if cfg.family == "ssm":
        return make({"conv": P(None, b, None, m),
                     "state": P(None, b, m, None, None)})
    if cfg.family == "hybrid":
        tree = {"attn_k": P(None, b, None, kv, hd),
                "attn_v": P(None, b, None, kv, hd),
                "super_conv": P(None, None, b, None, m),
                "super_state": P(None, None, b, m, None, None)}
        n_super = cfg.n_layers // cfg.attn_every
        if cfg.n_layers - n_super * cfg.attn_every:
            tree["tail_conv"] = P(None, b, None, m)
            tree["tail_state"] = P(None, b, m, None, None)
        return make(tree)
    return make({"k": P(None, b, None, kv, hd),
                 "v": P(None, b, None, kv, hd)})
