"""Multi-pod dry run: every (arch x shape x mesh) cell's step, counted on
placeholder ranks.

Like the JAX package's ``launch/dryrun.py`` (which lowers and compiles each
cell over 512 placeholder CPU devices), this touches no device.  Each cell
runs as rank 0 of a placeholder process group of 256 or 512 ranks
(``backend="fake"``: its collectives move nothing) over the production
mesh; every tensor is a DTensor whose local shard lives on the ``meta``
device, so shapes, placements and collectives are real and no data is.
The step is the port's own, under :func:`~repro_torch.distributed.sharding.
use_sharding`: ``loss_fn`` + backward + ``adamw_update`` (which clips by
the global norm) for train, ``forward(..., logits_last_only=True)`` for
prefill, ``decode_step`` (at the cache's last position) for decode.
``launch/cost_analysis.py`` counts it, per rank, and records:

* ``memory`` — argument bytes and the peak of live local bytes, beside the
  H100's 80 GB (``fits``);
* per-rank flops, bytes and collective bytes by op type;
* the roofline terms over the H100 SXM's constants, and the policy knobs.

Three choices, and why.  The local shards are ``meta`` tensors, not
``FakeTensorMode`` ones: under a fake mode DTensor's own offset arithmetic
for merged sharded dims calls ``int()`` on fake tensors and fails.  The
mesh is typed ``cuda``: on a ``cpu`` mesh DTensor replaces every
all-to-all by an all-gather (gloo's fallback).  Neither touches a device.
And DTensor before strided-shard views (torch 2.11) refuses a view that
flattens a dim sharded after the first, which newer DTensor (2.13) keeps
sharded: :class:`ViewFallback` gathers those dims first there, so a cell
runs on either, with more all-gathers on the older (``view_gathers``
counts them).  The reference's ``raw_cost_analysis`` and ``hlo_ops``
keys are left out (there is no compiled module to read them from: see
``omitted`` in each record).  A cell whose op has no DTensor sharding rule
records ``status: "error"`` with the op (``error_op``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--jobs 4]
  ... --policy no_seq_parallel,no_fsdp   # ablation knobs
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig, ShapeCell,
                                      get_config)
from repro_torch.distributed.sharding import (param_sharding_tree,
                                              use_sharding)
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import (cache_shardings, input_shardings,
                                     make_ctx, make_production_mesh)
from repro_torch.models import model_api
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

# H100 SXM constants (per card).
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
# One 400 Gb/s NDR InfiniBand port a GPU, each way.  Every axis of the
# (16, 16) and (2, 16, 16) meshes spans more than one 8-GPU node, so
# NVLink's 450 GB/s never bounds a group of these meshes.
LINK_BW = 50e9               # bytes/s a card
HBM_BYTES = 80e9             # device memory a card

OMITTED = {
    "raw_cost_analysis": "no compiled module: eager PyTorch has no XLA "
                         "cost_analysis to read",
    "hlo_ops": "no HLO: the counter sees the ops as they run",
    "lower_s": "seconds to make the placeholder state and model",
    "compile_s": "seconds of the counted step (nothing is compiled)",
}


# ---------------------------------------------------------------------------
# Placeholder ranks and state
# ---------------------------------------------------------------------------
def placeholder_group(world_size: int) -> None:
    """Make this process rank 0 of a placeholder group of ``world_size``
    ranks (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def placeholder(shape, dtype, sharding):
    """A DTensor of global ``shape`` placed as ``sharding`` (a
    :class:`~repro_torch.distributed.sharding.NamedSharding`), its local
    shard on the meta device."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, placements = sharding.mesh, sharding.placements
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    full = torch.empty(shape, dtype=dtype, device="meta")
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        run_check=False, shape=full.shape, stride=full.stride())


def abstract_state(cfg: ArchConfig, cell: ShapeCell, ctx, *,
                   param_dtype=torch.bfloat16):
    """(model, opt state or cache or None, batch) as placeholders: the
    parameters as ``param_sharding_tree`` places them, AdamW's moments
    (float32) like them, the batch by ``input_shardings``, the decode cache
    by ``cache_shardings``."""
    pd = model_api.pdefs(cfg)
    shardings = param_sharding_tree(pd, ctx)

    def make(d, s):
        if isinstance(d, dict):
            return {k: make(d[k], s[k]) for k in d}
        return placeholder(d.shape, param_dtype, s)

    model = model_api.build_model(cfg, make(pd, shardings))
    ins = input_shardings(ctx, cfg, cell)
    # the stub frontends' float inputs come in the parameters' dtype (the
    # port's products take one dtype; the reference's einsums promote)
    batch = {k: placeholder(s.shape, s.dtype if s.dtype == torch.int32
                            else param_dtype, ins[k])
             for k, s in model_api.batch_shapes(cfg, cell).items()
             if k != "pos"}
    if cell.kind == "train":
        params = dict(model.named_parameters())
        return model, OptState(
            step=torch.zeros((), dtype=torch.int32, device="meta"),
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}), batch
    if cell.kind == "decode":
        cs = cache_shardings(ctx, cfg, cell)
        cache = {k: placeholder(s.shape, s.dtype, cs[k])
                 for k, s in model_api.cache_shapes(
                     cfg, cell.global_batch, cell.seq_len).items()}
        return model, cache, batch
    return model, None, batch


# ---------------------------------------------------------------------------
# Views DTensor refuses
# ---------------------------------------------------------------------------
def view_dims_to_gather(src, dst) -> set:
    """Dims of ``src`` that a view to ``dst`` merges into a dim other than
    as its first (major) member (dim 1 of (B, L, D) -> (B*L, D)), or splits
    into several (dim 2 of (B, L, H*d) -> (B, L, H, d)): the dims an older
    DTensor cannot keep sharded through the view, and any DTensor not
    where the split is uneven."""
    out, i, j = set(), 0, 0
    src, dst = list(src), list(dst)
    while i < len(src) and j < len(dst):
        a, b, i0 = src[i], dst[j], i
        seen = src[i] != 1          # the group's first dim of size > 1
        parts = int(dst[j] != 1)    # the group's dst dims of size > 1
        while a != b:
            if a < b:
                i += 1
                a *= src[i]
                if src[i] != 1:
                    if seen:
                        out.add(i)
                    seen = True
            else:
                j += 1
                b *= dst[j]
                parts += dst[j] != 1
        if parts > 1 and i == i0:
            out.add(i0)
        i, j = i + 1, j + 1
    return out


class ViewFallback:
    """DTensor refuses some views GSPMD pads through: older DTensor (before
    strided-shard views, e.g. torch 2.11) one that flattens a dim sharded
    after the first of the merged dims (``(B, L, D) -> (B*L, D)`` with L on
    "model"), which newer DTensor keeps sharded, and any DTensor one that
    splits a dim sharded unevenly for the split (24 heads of 64 from a
    1536-wide dim in 16 shards).  Under this mode such a view gathers those
    dims first (their all-gathers reach the counter below it) and runs
    again; a view DTensor takes passes untouched."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                return self._dispatch(func, types, args, kwargs or {})
        self.mode = _Mode()
        self.gathers = 0

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        from torch.distributed.tensor._redistribute import \
            redistribute_local_tensor
        views = (torch.ops.aten.view.default,
                 torch.ops.aten._unsafe_view.default)
        if func not in views or not isinstance(args[0], DTensor):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented       # DTensor's own dispatch
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if "flatten" not in str(e):
                raise
        x = args[0]
        dims = view_dims_to_gather(x.shape, args[1])
        pl = [Replicate() if p.is_shard() and p.dim in dims else p
              for p in x.placements]
        if pl == list(x.placements):
            raise RuntimeError(f"{func}: no gather makes {tuple(x.shape)} "
                               f"-> {tuple(args[1])} a view DTensor takes")
        spec = DTensorSpec(x.device_mesh, tuple(pl),
                           tensor_meta=x._spec.tensor_meta)
        local = redistribute_local_tensor(x._local_tensor, x._spec, spec)
        self.gathers += 1
        return func(DTensor(local, spec, requires_grad=x.requires_grad),
                    *args[1:], **kwargs)


# ---------------------------------------------------------------------------
# Step functions per cell kind
# ---------------------------------------------------------------------------
def build_step(cfg: ArchConfig, cell: ShapeCell, opt_cfg: AdamWConfig,
               knobs=frozenset()):
    """The cell's step as ``step(model, state, batch) -> outputs``."""
    if cell.kind == "train":
        def train_step(model, opt_state, batch):
            model.requires_grad_(True)
            loss, metrics = model_api.loss_fn(model, cfg, batch)
            loss.backward()
            params = dict(model.named_parameters())
            grads = {k: p.grad for k, p in params.items()}
            new_p, new_o, om = adamw_update(opt_cfg, params, grads,
                                            opt_state)
            return new_p, new_o, dict(metrics, **om)
        return train_step
    if cell.kind == "prefill":
        # Serving prefill emits only the final position's logits (the
        # decode seed); "full_logits" restores the naive variant.
        last_only = "full_logits" not in knobs

        @torch.no_grad()
        def prefill_step(model, _, batch):
            logits, _ = model_api.forward(model, cfg, batch, remat=False,
                                          logits_last_only=last_only)
            return logits
        return prefill_step

    @torch.no_grad()
    def serve_step(model, cache, batch):
        return model_api.decode_step(model, cfg, cache, batch["tokens"],
                                     cell.seq_len - 1)
    return serve_step


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------
def _error_op(msg: str) -> Optional[str]:
    m = re.search(r"\b(aten\.[\w.]+|_c10d_functional\.[\w.]+)", msg)
    return m.group(1) if m else None


def run_cell(arch: str, shape: str, mesh_kind: str, *,
             policy: Optional[str] = None,
             out_dir: str = "results/dryrun_torch", verbose: bool = True,
             cfg: Optional[ArchConfig] = None,
             cell: Optional[ShapeCell] = None) -> dict:
    """Count one cell (``cfg`` and ``cell`` override ``arch``'s
    configuration and ``shape``'s sizes, e.g. reduced ones) and write its
    record to ``out_dir``."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    ok, why = cfg.supports(shape)
    if not ok:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "skipped", "reason": why}
        _write(rec, out_dir, arch, shape, mesh_kind, policy)
        return rec

    multi = mesh_kind == "multi"
    placeholder_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    knobs = set((policy or "").split(",")) - {""}
    ctx = make_ctx(mesh, cfg, cell,
                   fsdp=False if "no_fsdp" in knobs else None,
                   seq_parallel=False if "no_seq_parallel" in knobs else None)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "policy": sorted(knobs), "kind": cell.kind,
           "n_devices": mesh.size(), "omitted": OMITTED,
           "sharding": {k: getattr(ctx, k) for k in (
               "batch_axes", "fsdp", "seq_parallel", "kv_axis",
               "attn_q_axis", "expert_tp2")}}
    t0 = time.time()
    try:
        step = build_step(cfg, cell, AdamWConfig(), frozenset(knobs))
        model, state, batch = abstract_state(cfg, cell, ctx)
        t_state = time.time() - t0
        with cost_analysis.CostCounter() as counter:
            args = counter.hold((list(model.parameters()), state, batch))
            with use_sharding(ctx), implicit_replication(), \
                    ViewFallback() as views:
                out = step(model, state, batch)
            t_step = time.time() - t0 - t_state
            out_bytes = cost_analysis._nbytes(out)
        an = counter.result()
        coll = dict(an["collective_bytes"])
        coll.update({f"n_{k}": v for k, v in an["collective_ops"].items()})
        rec.update(
            status="ok",
            lower_s=round(t_state, 2), compile_s=round(t_step, 2),
            flops_per_device=an["flops"],
            bytes_per_device=an["bytes"],
            collective_bytes=coll,
            memory={"argument_size_in_bytes": args,
                    "output_size_in_bytes": out_bytes,
                    "temp_size_in_bytes": counter.peak_bytes - args,
                    "peak_bytes": counter.peak_bytes,
                    "hbm_bytes": HBM_BYTES,
                    "fits": counter.peak_bytes <= HBM_BYTES},
            kernel_calls=dict(counter.kernel_calls),
            view_gathers=views.gathers,
            model_flops=model_flops(cfg, cell),
        )
        rec["terms"] = roofline_terms(rec)
    except Exception as e:  # noqa: BLE001 — a failed cell is a record
        msg = f"{type(e).__name__}: {e}"
        rec.update(status="error", error=msg[:2000], error_op=_error_op(msg),
                   traceback=traceback.format_exc()[-2000:])
    _write(rec, out_dir, arch, shape, mesh_kind, policy)
    if verbose:
        s = rec["status"]
        extra = ""
        if s == "ok":
            t = rec["terms"]
            extra = (f" compute={t['compute_s']:.2e}s memory="
                     f"{t['memory_s']:.2e}s coll={t['collective_s']:.2e}s "
                     f"dom={t['dominant']} peak="
                     f"{rec['memory']['peak_bytes'] / 1e9:.1f}GB "
                     f"({time.time() - t0:.1f} s)")
        elif s == "error":
            extra = f" {rec['error_op']}: " + rec["error"][:160]
        print(f"[dryrun] {arch} x {shape} x {mesh_kind}: {s}{extra}",
              flush=True)
    return rec


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode, one
    token), with N = active params (MoE: top-k slice)."""
    n = model_api.n_active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch


def roofline_terms(rec: dict) -> dict:
    """The three roofline terms in seconds (per-rank quantities over
    per-card peaks)."""
    coll = rec["collective_bytes"]
    cbytes = sum(v for k, v in coll.items()
                 if k in cost_analysis.COLLECTIVES)
    terms = {
        "compute_s": rec["flops_per_device"] / PEAK_FLOPS,
        "memory_s": rec["bytes_per_device"] / HBM_BW,
        "collective_s": cbytes / LINK_BW,
    }
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    terms["dominant"] = dominant.replace("_s", "")
    total_flops = rec["flops_per_device"] * rec["n_devices"]
    terms["useful_flop_ratio"] = (rec["model_flops"] / total_flops
                                  if total_flops else 0.0)
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    ideal = rec["model_flops"] / (rec["n_devices"] * PEAK_FLOPS)
    terms["roofline_fraction"] = ideal / bound if bound > 0 else 0.0
    return terms


def _write(rec: dict, out_dir: str, arch: str, shape: str, mesh: str,
           policy: Optional[str]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _tag(arch, shape, mesh, policy)
                           + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _tag(arch: str, shape: str, mesh: str, policy: Optional[str]) -> str:
    tag = f"{arch}__{shape}__{mesh}"
    if policy:
        tag += "__" + policy.replace(",", "+")
    return tag


# ---------------------------------------------------------------------------
def _run_jobs(cells, args) -> int:
    """Each cell in a process of its own, ``args.jobs`` at a time (a
    process holds one placeholder group); returns the cells in error."""
    pending = list(cells)
    running = []
    failures = 0
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mk = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mk,
                   "--out", args.out]
            if args.policy:
                cmd += ["--policy", args.policy]
            running.append(subprocess.Popen(cmd))
        time.sleep(0.2)
        for p in [p for p in running if p.poll() is not None]:
            running.remove(p)
            failures += p.returncode != 0
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="comma list: no_fsdp,no_seq_parallel,full_logits")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, mk)
             for a, s in ([(a, s) for a in ARCH_IDS for s in SHAPES]
                          if args.all else [(args.arch, args.shape)])
             for mk in meshes]
    if args.jobs > 1:
        return 1 if _run_jobs(cells, args) else 0
    failures = 0
    for arch, shape, mk in cells:
        rec = run_cell(arch, shape, mk, policy=args.policy, out_dir=args.out)
        failures += rec["status"] == "error"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
