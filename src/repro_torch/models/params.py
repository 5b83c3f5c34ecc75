"""Declarative parameter trees.

A model's parameters are declared once as a tree (nested dicts) of
:class:`PDef` (shape + init + scale + stacked-layer prefix count), with the
JAX package's shapes and names; :func:`materialize` fills it with tensors
and :func:`n_params` counts it.  The models unstack the leading layer axes
into ``nn.ModuleList``s (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    logical: Optional[str] = None   # the JAX package's sharding name
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # default: 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32
    stacked: int = 0                # leading stacked-layer axes


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                             object]]:
    """(path, leaf) of every leaf of a tree of dicts (PDefs or tensors),
    keys in sorted order (as JAX flattens a dict)."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k in sorted(tree):
        yield from leaves(tree[k], path + (k,))


def check_tree(arch_id: str, want, got) -> None:
    """Raise on a key of the PDef tree ``want`` missing from the tensor
    tree ``got``, a key too many, or a shape that differs."""
    want, got = dict(leaves(want)), dict(leaves(got))
    if set(got) != set(want):
        missing = sorted(".".join(k) for k in set(want) - set(got))
        extra = sorted(".".join(k) for k in set(got) - set(want))
        raise KeyError(f"parameter tree of {arch_id}: missing {missing}, "
                       f"extra {extra}")
    for path, d in want.items():
        if tuple(got[path].shape) != tuple(d.shape):
            raise ValueError(f"{'.'.join(path)}: shape "
                             f"{tuple(got[path].shape)}, expected {d.shape}")


def split_name(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A model parameter's name (``layers.3.attn.wq``) as its key path in
    the JAX package's stacked tree (``("layers", "attn", "wq")``) and its
    index on the stacked axes it was unstacked from (``(3,)``)."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def keystr(path: Tuple[str, ...]) -> str:
    """A path of dict keys as ``jax.tree_util.keystr`` writes it:
    ``['layers']['attn']['wq']``."""
    return "".join(f"[{k!r}]" for k in path)


def ref_keystr(name: str) -> str:
    """The key path, in the JAX package's stacked tree, of the model
    parameter ``name``."""
    return keystr(split_name(name)[0])


def layer(tree, *index):
    """The tree of one stacked layer: every leaf indexed by ``index`` on
    its leading axes (views, not copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, *index) for k, v in tree.items()}
    return tree[index]


def n_params(tree) -> int:
    return int(sum(math.prod(d.shape) for _, d in leaves(tree)))


def materialize(tree, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Real parameters on ``device`` with the JAX package's shapes, init
    kinds and scales: zeros, ones, or normal draws times ``scale`` (default
    ``1/sqrt(fan_in)``, ``fan_in = shape[-2]``).  The draws come from
    ``generator`` in the leaves' sorted order, on the generator's device,
    so a seed gives the same values on every run; they cannot equal the
    JAX package's, which come from its own generator."""
    device = resolve_device(device)

    def one(d: PDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        t = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device).mul_(scale)
        return t.to(device=device, dtype=d.dtype)

    out: dict = {}
    for path, d in leaves(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = one(d)
    return out
