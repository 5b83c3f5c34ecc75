"""Logical-axis sharding rules and the ``shard`` constraint helper, as the
JAX package's ``distributed/sharding.py`` states them, over a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

Models annotate activations with *logical* names (``"act_btd"`` etc.); the
active :class:`ShardingCtx` maps them to specs over the production mesh
``(pod, data, model)`` (or ``(data, model)`` single-pod).  Without a context
every annotation returns its input, so the same model code runs on one card
and on a mesh of ranks.

A spec (:class:`P`) names, for each tensor dim, the mesh axes it is split
over: ``None``, one axis name, or a tuple of names (major to minor).
DTensor's placements name, for each mesh dim, the tensor dim it splits:
:func:`to_placements` turns one into the other.  With a context, ``shard``,
``shard_seq`` and ``gather_fsdp`` ``redistribute`` a DTensor to the spec
(the reference's ``with_sharding_constraint``).  DTensor shards an uneven
dim in ``torch.chunk`` fashion where GSPMD pads; :func:`sanitize_spec`
covers parameters and inputs only, as in the reference.

Axis plan: ``pod`` x ``data`` carry the batch and the gradient reduction;
``model`` carries heads, the MLP hidden dim, experts and the vocabulary;
FSDP shards parameters on ``data`` too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping
from typing import Optional

import torch

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim (trailing dims may be
    left out), each ``None``, a mesh-axis name or a tuple of names.  A
    one-name tuple is stored as the name, as JAX's ``PartitionSpec``
    stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def axis_names(mesh) -> tuple:
    """The mesh's axis names (a DeviceMesh's ``mesh_dim_names``, or a
    stand-in's ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> extent, for a DeviceMesh or a stand-in whose ``shape``
    is a mapping (the reference's ``Mesh.shape``)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


@dataclasses.dataclass
class ShardingCtx:
    mesh: object                 # DeviceMesh (or a stand-in, for specs)
    batch_axes: tuple            # ("pod", "data") or ("data",)
    model_axis: str = "model"
    fsdp: bool = False           # shard params on the data axis too
    seq_shard_decode: bool = False  # long-context: shard KV cache sequence
    seq_parallel: bool = False   # shard layer-boundary activations on seq
    kv_axis: str = "heads"       # "heads" | "hd" | "none": KV model placement
    attn_q_axis: str = "heads"   # "heads" | "hd" | "seq" | "none".  "seq"
                                 # shards the QUERY sequence on the model
                                 # axis (ring-attention-style work split)
                                 # for train/prefill when heads don't
                                 # divide: KV replicates, scores stay
                                 # local, attention flops shard by q rows.
    expert_tp2: bool = False     # serve-time: shard expert F dim on "data"
                                 # (EP x TP2 - no weight all-gather per step)

    @property
    def fsdp_axis(self) -> Optional[str]:
        return "data" if self.fsdp else None

    def spec(self, name: str) -> P:
        b, m, f = self.batch_axes, self.model_axis, self.fsdp_axis
        table = {
            # activations
            "act_btd": P(b, None, None),
            "act_btd_sp": P(b, m, None),   # sequence-parallel layer boundary
            "act_btf": P(b, None, m),          # mlp hidden
            "act_bthd": {"heads": P(b, None, m, None),
                         "hd": P(b, None, None, m),
                         "seq": P(b, m, None, None),
                         "none": P(b, None, None, None)}[self.attn_q_axis],
            "act_bhts": P(b, m, None, None),   # attention scores
            "logits": P(b, None, m),           # (B, L, vocab)
            "tokens": P(b, None),
            # kv cache (B, S, kv_heads, hd): model axis on heads when they
            # divide it, else on head_dim, else replicated (see kv_axis)
            "kv_cache": P(b, "data" if self.seq_shard_decode else None,
                          m if self.kv_axis == "heads" else None,
                          m if self.kv_axis == "hd" else None),
            "ssm_state": P(b, m, None, None),  # (B, H, dh, N)
            # params
            "p_embed": P(m, f),                # (vocab, d)
            "p_norm": P(None),
            "p_attn_qkv": {"heads": P(f, m, None),
                           "hd": P(f, None, m),
                           "seq": P(f, None, None),
                           "none": P(f, None, None)}[self.attn_q_axis],
            "p_attn_o": {"heads": P(m, None, f),
                         "hd": P(None, m, f),
                         "seq": P(None, None, f),
                         "none": P(None, None, f)}[self.attn_q_axis],
            "p_mlp_in": P(f, m),               # (d, ff)
            "p_mlp_out": P(m, f),              # (ff, d)
            "p_router": P(f, None),            # (d, experts)
            "p_expert_in": (P(m, None, "data") if self.expert_tp2
                            else P(m, f, None)),    # (E, d, ff)
            "p_expert_out": (P(m, "data", None) if self.expert_tp2
                             else P(m, None, f)),   # (E, ff, d)
            "p_ssm_in": P(f, m),               # (d, inner_proj)
            "p_ssm_out": P(m, f),              # (inner, d)
            "p_ssm_small": P(m),               # per-head A, D, dt_bias
            "p_conv": P(None, m),              # (k, inner)
            # moe dispatch buffers (E, cap, d): experts on model, capacity
            # rows on the batch axes (otherwise every data-axis device
            # recomputes the full capacity)
            "moe_buf": P(m, b, None),
        }
        return table[name]


def get_ctx() -> Optional[ShardingCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    prev = get_ctx()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def to_placements(spec, mesh) -> list:
    """DTensor placements (one per mesh dim) of a tensor-dim -> mesh-axes
    spec.  A tuple entry such as ``("pod", "data")`` puts ``Shard(d)`` on
    each of those mesh dims; DTensor splits mesh dims in mesh order, so the
    names must come in the mesh's order (JAX's major-to-minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for md in dims:
            if not out[md].is_replicate():
                raise ValueError(f"mesh axis {names[md]!r} used twice in "
                                 f"{spec!r}")
            out[md] = Shard(d)
    return out


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``; the gradient goes back to
    the input's placements, a partial sum's as replicated (the transpose of
    a sharding constraint).  DTensor's own ``redistribute`` cannot take a
    partial-sum gradient back to a masked partial sum (a vocab-sharded
    embedding's output)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.src = x.placements
        ctx.mesh = x.device_mesh
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate
        back = [Replicate() if p.is_partial() else p for p in ctx.src]
        return grad.redistribute(ctx.mesh, back), None


def constrain(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``x`` redistributed to ``spec`` over ``mesh``; a plain tensor is
    taken as replicated (DTensor's implicit replication).  A dim of size 1
    stays whole (GSPMD pads it; DTensor would leave it on one rank, and
    no view could reshape it)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    spec = P(*(None if d < x.ndim and x.shape[d] == 1 else e
               for d, e in enumerate(spec)))
    return _Constrain.apply(x, tuple(to_placements(spec, mesh)))


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """Apply the logical constraint if a sharding context is active."""
    ctx = get_ctx()
    if ctx is None:
        return x
    return constrain(x, ctx.spec(name), ctx.mesh)


def _items(tree):
    """(key, value) of a mapping, or of a module of the port's models
    (its own parameters, then its sub-modules)."""
    if isinstance(tree, Mapping):
        return list(tree.items())
    return list(tree._parameters.items()) + list(tree._modules.items())


def gather_fsdp(tree, names: dict):
    """Explicitly all-gather FSDP-sharded weights at layer entry.

    Constraining each per-layer weight to its spec *minus the fsdp axis*
    gathers the weights and keeps activations batch-sharded (the
    reference's remedy for GSPMD resharding the activations instead).

    ``tree`` is a mapping or a module of the port's models; ``names`` maps
    leaf key -> logical spec name, and keys absent from ``names`` pass
    through untouched.  Returns ``tree`` itself outside a sharding context
    or when fsdp is off, else a dict."""
    ctx = get_ctx()
    if ctx is None or not ctx.fsdp:
        return tree
    gctx = dataclasses.replace(ctx, fsdp=False)

    def one(key, leaf):
        logical = names.get(key)
        if logical is None or not isinstance(leaf, torch.Tensor):
            return leaf
        spec = sanitize_spec(leaf.shape, gctx.spec(logical), ctx.mesh)
        return constrain(leaf, spec, ctx.mesh)

    return {k: (one(k, v) if isinstance(v, torch.Tensor)
                else {k2: one(k2, v2) for k2, v2 in _items(v)})
            for k, v in _items(tree)}


ATTN_LOGICAL = {"wq": "p_attn_qkv", "wk": "p_attn_qkv", "wv": "p_attn_qkv",
                "wo": "p_attn_o"}
MLP_LOGICAL = {"w_in": "p_mlp_in", "w_gate": "p_mlp_in", "w_out": "p_mlp_out"}
MOE_LOGICAL = {"router": "p_router", "w_gate": "p_expert_in",
               "w_in": "p_expert_in", "w_out": "p_expert_out"}
SSM_LOGICAL = {"w_in": "p_ssm_in", "w_out": "p_ssm_out", "conv_w": "p_conv"}


def shard_seq(x: torch.Tensor) -> torch.Tensor:
    """Sequence-parallel constraint at layer boundaries: shard (B, L, D) on
    L over the model axis when the context enables it and L divides the
    axis (train/prefill only; decode has L == 1)."""
    ctx = get_ctx()
    if ctx is None or not ctx.seq_parallel:
        return x
    n_model = axis_sizes(ctx.mesh)[ctx.model_axis]
    if x.ndim < 2 or x.shape[1] % n_model != 0:
        return x
    return constrain(x, ctx.spec("act_btd_sp"), ctx.mesh)


def named_sharding(name: str):
    """``(mesh, placements)`` of a logical name under the active context,
    or ``None`` without one."""
    ctx = get_ctx()
    if ctx is None:
        return None
    return ctx.mesh, to_placements(ctx.spec(name), ctx.mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``): ``.spec`` and the
    DTensor ``.placements`` it stands for."""
    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def sanitize_spec(shape, spec, mesh) -> P:
    """Drop partitioning on dims the mesh extent does not evenly divide.

    Inputs and parameters are placed evenly (the reference's jit input
    shardings require it); a dropped axis means that tensor is replicated
    along it, e.g. 36 attention heads on a 16-way model axis."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        for a in axes:
            extent *= sizes[a]
        out.append(entry if dim % extent == 0 else None)
    return P(*out)


def param_sharding_tree(pdef_tree, ctx: ShardingCtx) -> dict:
    """Map a PDef tree (``models/params.py``) to :class:`NamedSharding`s.
    Stacked-layer leading axes (``PDef.stacked``) get a ``None`` prefix on
    the spec; specs are sanitized against the shapes (uneven dims ->
    replicated)."""
    from repro_torch.models.params import PDef

    def one(d):
        if isinstance(d, dict):
            return {k: one(v) for k, v in d.items()}
        assert isinstance(d, PDef)
        spec = ctx.spec(d.logical) if d.logical else P()
        spec = P(*((None,) * d.stacked + tuple(spec)))
        return NamedSharding(ctx.mesh, sanitize_spec(d.shape, spec,
                                                     ctx.mesh))

    return one(pdef_tree)
