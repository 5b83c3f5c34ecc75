"""Per-rank op-cost counter: the counterpart of the JAX package's
``launch/hlo_analysis.py``.

The reference re-derives a compiled step's costs from XLA's HLO text.
PyTorch produces no HLO, so this module counts the ops as they run: a
``TorchDispatchMode`` that lets DTensor desugar first (it returns
``NotImplemented`` for DTensor arguments, as ``CommDebugMode`` does) and so
sees the local per-rank ops and the collectives DTensor issues.  It
returns the reference's dict (:func:`analyze`):

* ``flops`` — every op ``torch.utils.flop_counter`` has a formula for
  (mm, addmm, bmm, baddbmm, convolution, ...) by that formula on local
  shapes;
* ``bytes`` — operand plus result bytes of every op that moves data;
  views, ``detach`` and the like are free (the reference's ``_FREE_OPS``);
* ``collective_bytes`` / ``collective_ops`` — operand bytes and counts per
  ``c10d`` / ``_c10d_functional`` / DTensor op, under the reference's
  :data:`COLLECTIVES` names (point-to-point sends as
  ``collective-permute``).

Eager code unrolls loops, so no trip-count correction is needed.

Kernels.  The CUDA kernels are loaded with ``ctypes``, so no dispatch mode
sees them; the K3 and K4 wrappers report each call themselves
(:func:`report_kernel`): the plain version's flops (counted on meta copies
of the inputs) and, as bytes, the call's inputs and output only — the
reference's rule for fusion interiors.  Where the wrappers run the plain
version instead (CPU or meta tensors, as in the dry run), the same rule
applies inside it (:func:`fused`).

:class:`CostCounter` also tracks the bytes of live local storages: what it
is given as arguments (:meth:`CostCounter.hold`) plus every storage an op
creates, until it is freed; ``peak_bytes`` is the largest sum.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import torch
from torch._guards import active_fake_mode as _active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

# op name fragment -> reference name; the first match wins
_COLL_NAMES = (("reduce_scatter", "reduce-scatter"),
               ("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
               ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
               ("send", "collective-permute"))
# c10d's in-place ops take (output, input, ...): the operand is args[1]
_OUT_FIRST = ("_allgather_base_", "_reduce_scatter_base_", "alltoall_base_",
              "allgather_into_tensor_coalesced_",
              "reduce_scatter_tensor_coalesced_")
# ops that move no data (views are found from their schemas)
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_strided",
         "empty_like", "wait_tensor", "_local_scalar_dense", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "recv_"}

_ACTIVE: List["CostCounter"] = []


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, dicts), without a full pytree walk for the usual
    flat cases."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (list, tuple)):
        out = []
        for a in tree:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple, dict)):
                out.extend(_tensors(a))
        return out
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _nbytes(tree) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


def _coll_name(func) -> Optional[str]:
    ns, _, name = func.name().partition("::")
    if ns not in ("c10d", "_c10d_functional", "_dtensor"):
        return None
    name = name.split(".")[0]
    for frag, ref in _COLL_NAMES:
        if frag in name:
            return ref
    return None


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes and collectives of the ops run under it (see the
    module docstring); read the totals with :meth:`result`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.n_coll = {k: 0 for k in COLLECTIVES}
        self.kernel_calls: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: Dict[int, weakref.ref] = {}
        self._fused = 0
        self._fake_on_entry = None

    # -- live storages -----------------------------------------------------
    def _free(self, key: int, nbytes: int, _ref=None) -> None:
        if self._held.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def hold(self, tree) -> int:
        """Track the local storages of ``tree``'s tensors as live; returns
        the bytes newly tracked."""
        added = 0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            key = id(st)
            if key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = weakref.ref(
                st, lambda r, k=key, n=n: self._free(k, n))
            self.live_bytes += n
            added += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        self._fake_on_entry = _active_fake_mode()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor's sharding propagation may run ops under a fake mode of
        # its own: those are metadata, not work of this rank
        if _active_fake_mode() is self._fake_on_entry:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        coll = _coll_name(func)
        name = func.name().partition("::")[2].split(".")[0]
        if coll is not None:
            operand = args[1] if name in _OUT_FIRST else args[0]
            self.coll[coll] += _nbytes(operand)
            self.n_coll[coll] += 1
        if self._fused:
            return              # a fusion interior: no bytes, no buffers
        if coll is None and not func.is_view and name not in _FREE:
            self.bytes += (_nbytes(args) + _nbytes(kwargs) + _nbytes(out))
        self.hold(out)

    def add_fused(self, name: str, flops: int, inputs, outputs) -> None:
        """One fused call: its flops, and its inputs and outputs as its
        only bytes."""
        self.flops += int(flops)
        self.bytes += _nbytes(inputs) + _nbytes(outputs)
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def result(self) -> Dict[str, object]:
        """The reference's ``hlo_analysis.analyze`` dict."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": dict(self.coll),
                "collective_ops": dict(self.n_coll)}


def active() -> Optional[CostCounter]:
    """The innermost counter in use, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


def fused(name: str, fn, inputs: tuple, *args, **kwargs):
    """``fn(*inputs, *args, **kwargs)`` (a kernel's plain version) counted
    as one fused call: the flops of the ops inside it, and as bytes only
    ``inputs`` and the result."""
    c = active()
    if c is None:
        return fn(*inputs, *args, **kwargs)
    flops0 = c.flops
    c._fused += 1
    try:
        out = fn(*inputs, *args, **kwargs)
    finally:
        c._fused -= 1
    inner, c.flops = c.flops - flops0, flops0
    c.add_fused(name, inner, inputs, out)
    c.hold(out)
    return out


def plain_flops(fn, inputs: tuple, *args, **kwargs) -> int:
    """The flops of ``fn(*inputs, ...)`` counted on meta copies of the
    inputs (no data is touched), outside any active counter."""
    from torch.utils._python_dispatch import _disable_current_modes
    saved = list(_ACTIVE)
    _ACTIVE.clear()
    try:
        with _disable_current_modes():
            metas = tuple(torch.empty_like(_local(t), device="meta")
                          if isinstance(t, torch.Tensor) else t
                          for t in inputs)
            with CostCounter() as c, torch.no_grad():
                fn(*metas, *args, **kwargs)
    finally:
        _ACTIVE[:] = saved
    return c.flops


def report_kernel(name: str, plain, inputs: tuple, out, *args,
                  **kwargs) -> None:
    """Report one kernel launch, which no dispatch mode sees, to the
    active counter: the flops of its plain version ``plain(*inputs, *args,
    **kwargs)`` on the same shapes, and its inputs and output as bytes."""
    c = active()
    if c is not None:
        c.add_fused(name, plain_flops(plain, inputs, *args, **kwargs),
                    inputs, out)


def analyze(fn, *args, **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` under a counter and return its
    :meth:`CostCounter.result`."""
    with CostCounter() as c:
        fn(*args, **kwargs)
    return c.result()
