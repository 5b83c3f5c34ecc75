"""Explicit collectives: hierarchical gradient reduction, bucketed reduction,
and int8 gradient compression with error feedback, as the JAX package's
``distributed/collectives.py`` computes them, over a ``DeviceMesh``'s
per-axis process groups (``mesh.get_group("data")``).

* :func:`hierarchical_psum` — reduce-scatter over the intra-pod ``data``
  axis, then all-reduce over the ``pod`` axis (one buffer holding every
  leaf's piece), then all-gather back over ``data``.  The slow inter-pod
  hop carries 1/|data| of the gradient.
* :func:`compressed_pod_psum` — the same, with the cross-pod piece
  quantized to int8 with a per-leaf scale; error feedback (the residual
  carried between steps) keeps the quantization bias from accumulating.
* :func:`chunked_psum` — leaves grouped into byte buckets, each bucket
  flattened into one buffer and reduced with one all-reduce.

Every rank of the mesh calls these with its own tree (SPMD); each returns
the mean over the named axes.  Tensors are reduced on their own device: the
card's with NCCL, the CPU's with gloo.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed.sharding import axis_names, axis_sizes


def _group(mesh, axes):
    """The process group of one mesh axis, or of several together."""
    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _padded(g: torch.Tensor, n: int) -> Tuple[torch.Tensor, int]:
    """``g`` flattened and zero-padded to a multiple of ``n``."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _scatter(flat: torch.Tensor, n: int, group) -> torch.Tensor:
    """Sum-reduce-scatter of ``flat`` over ``group``: this rank's piece."""
    piece = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter_tensor(piece, flat.contiguous(), group=group)
    return piece


def _gather(piece: torch.Tensor, n: int, group) -> torch.Tensor:
    full = piece.new_empty(piece.numel() * n)
    dist.all_gather_into_tensor(full, piece.contiguous(), group=group)
    return full


def _pod_sum(pieces: list, group) -> list:
    """All-reduce (sum) of every piece at once, as one buffer."""
    buf = torch.cat(pieces)
    dist.all_reduce(buf, group=group)
    return list(buf.split([p.numel() for p in pieces]))


# ---------------------------------------------------------------------------
# Hierarchical reduction
# ---------------------------------------------------------------------------
def hierarchical_psum(tree, mesh, *, data_axis: str = "data",
                      pod_axis: str | None = "pod"):
    """Mean-reduce a gradient tree over (pod, data) hierarchically:
    reduce-scatter over ``data``, all-reduce over ``pod`` on the 1/|data|
    pieces, all-gather over ``data``.  Equivalent to one global mean."""
    has_pod = pod_axis is not None and pod_axis in axis_names(mesh)
    sizes = axis_sizes(mesh)
    n_data = sizes[data_axis]
    n_total = n_data * (sizes[pod_axis] if has_pod else 1)
    dg = _group(mesh, data_axis)
    leaves, spec = tree_flatten(tree)
    pads, pieces = [], []
    for g in leaves:
        flat, pad = _padded(g, n_data)
        pads.append(pad)
        pieces.append(_scatter(flat, n_data, dg))
    if has_pod:
        pieces = _pod_sum(pieces, _group(mesh, pod_axis))
    out = []
    for g, piece, pad in zip(leaves, pieces, pads):
        full = _gather(piece, n_data, dg)
        if pad:
            full = full[:-pad]
        out.append((full / n_total).reshape(g.shape))
    return tree_unflatten(out, spec)


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8, rounded half to even.  Returns (q,
    scale)."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_pod_psum(tree, mesh, error_state, *, data_axis: str = "data",
                        pod_axis: str = "pod"):
    """Hierarchical reduction with an int8-quantized cross-pod hop and
    error feedback.

    ``error_state`` is a tree like ``tree`` of the residuals from the
    previous step (:func:`init_error_state`); returns (reduced, new error
    state).  The residual is added *before* quantization (EF-SGD), so the
    bias is O(1) instead of O(steps)."""
    sizes = axis_sizes(mesh)
    n_pods, n_data = sizes[pod_axis], sizes[data_axis]
    dg = _group(mesh, data_axis)
    leaves, spec = tree_flatten(tree)
    errs = tree_flatten(error_state)[0]
    pads, deq, new_errs = [], [], []
    for g, err in zip(leaves, errs):
        flat, pad = _padded(g, n_data)
        pads.append(pad)
        carry = _scatter(flat, n_data, dg) + err
        q, scale = quantize_int8(carry)
        d = dequantize_int8(q, scale)
        new_errs.append(carry - d)
        deq.append(d)
    summed = _pod_sum(deq, _group(mesh, pod_axis))
    out = []
    for g, piece, pad in zip(leaves, summed, pads):
        full = _gather(piece, n_data, dg)
        if pad:
            full = full[:-pad]
        out.append((full / (n_data * n_pods)).reshape(g.shape))
    return tree_unflatten(out, spec), tree_unflatten(new_errs, spec)


def init_error_state(tree, mesh, *, data_axis: str = "data"):
    """Zero residuals (float32) of the reduce-scatter pieces' shapes."""
    n_data = axis_sizes(mesh)[data_axis]
    leaves, spec = tree_flatten(tree)
    out = []
    for g in leaves:
        n = g.numel() + (-g.numel()) % n_data
        out.append(torch.zeros(n // n_data, dtype=torch.float32,
                               device=g.device))
    return tree_unflatten(out, spec)


# ---------------------------------------------------------------------------
# Bucketed reduction
# ---------------------------------------------------------------------------
def chunked_psum(tree, mesh, axes: Sequence[str],
                 bucket_bytes: int = 32 << 20):
    """Mean over ``axes`` of every leaf, bucket by bucket (~bucket_bytes
    each, leaves largest first): each bucket is flattened into one buffer
    and reduced with one all-reduce, so a collective starts as soon as its
    bucket's gradients exist and small leaves share one."""
    leaves, spec = tree_flatten(tree)
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].numel())
    buckets, cur, cur_bytes = [], [], 0
    for i in order:
        cur.append(i)
        cur_bytes += leaves[i].numel() * leaves[i].element_size()
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)

    group = _group(mesh, axes)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    out = list(leaves)
    for b in buckets:
        buf = torch.cat([leaves[i].reshape(-1) for i in b])
        dist.all_reduce(buf, group=group)
        for i, r in zip(b, buf.split([leaves[i].numel() for i in b])):
            out[i] = r.reshape(leaves[i].shape) / n
    return tree_unflatten(out, spec)
