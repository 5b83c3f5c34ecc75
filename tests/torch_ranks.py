"""Multi-rank runs for the port's distributed tests: gloo ranks on the CPU,
each a process of its own.

``launch(n, job, inputs)`` starts ``n`` processes of this file, each rank
``r`` of a gloo group of ``n`` (``tcp://127.0.0.1:<free port>``), runs the
worker function ``job`` (below) with the inputs (a dict of numpy arrays
and plain values, passed through a pickle file) and returns each rank's
result dict.  Every wait is bounded; a rank that fails or hangs fails the
call with its stderr.  Workers import torch and the port only, never JAX.
"""
from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n: int, job: str, inputs: dict | None = None,
           timeout: float = 120.0) -> list:
    """Run worker ``job`` on ``n`` gloo ranks; returns their results in
    rank order."""
    tmp = Path(tempfile.mkdtemp(prefix="torch_ranks_"))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs or {}, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(r), str(n), str(port), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(n)]
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{job}: rank {r} timed out")
        if p.returncode != 0:
            errs.append(f"rank {r}: {err[-3000:]}")
    if errs:
        for q in procs:
            q.kill()
        raise AssertionError(f"{job} failed:\n" + "\n".join(errs))
    out = []
    for r in range(n):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Workers (run inside the rank processes)
# ---------------------------------------------------------------------------
def _np(t):
    return t.detach().cpu().numpy()


def job_collectives(rank, world, inp):
    """(2, 2, 2) ("pod", "data", "model"): hierarchical_psum and
    chunked_psum of distinct values; then a (2, 4) ("pod", "data") mesh:
    compressed_pod_psum of the reference test's input."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as co
    out = {}
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    tree = {k: torch.from_numpy(v[rank]) for k, v in inp["distinct"].items()}
    out["hier"] = {k: _np(v) for k, v in
                   co.hierarchical_psum(tree, mesh).items()}
    for axes in (("pod", "data"), ("data",)):
        out[f"chunked_{'_'.join(axes)}"] = {
            k: _np(v) for k, v in co.chunked_psum(tree, mesh, axes).items()}
    mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    g = {"w": torch.from_numpy(inp["w"])}
    err = co.init_error_state(g, mesh2)
    red, err2 = co.compressed_pod_psum(g, mesh2, err)
    out["compressed"] = _np(red["w"])
    out["compressed_err"] = _np(err2["w"])
    return out


def job_cost(rank, world, inp):
    """The cost counter around hierarchical_psum and chunked_psum of
    {"a": (128,), "b": (5, 3)} float32 on (2, 2, 2) ("pod", "data",
    "model")."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as co
    from repro_torch.launch import cost_analysis
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    tree = {k: torch.ones(s) for k, s in (("a", (128,)), ("b", (5, 3)))}
    return {
        "hier": cost_analysis.analyze(co.hierarchical_psum, tree, mesh),
        "chunked": cost_analysis.analyze(co.chunked_psum, tree, mesh,
                                         ("pod", "data"))}


def job_moe(rank, world, inp):
    """moe_block_a2a on a (4,) ("model",) mesh, then a (2, 2) ("data",
    "model") mesh: the output's blocks, aux, and the gradients of
    sum(out * cot) summed over the ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.moe_a2a import moe_block_a2a
    out = {}
    for name, shape, dims in (("m4", (4,), ("model",)),
                              ("d2m2", (2, 2), ("data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=dims)
        p = {k: torch.from_numpy(inp[k]).requires_grad_(True)
             for k in ("router", "w_gate", "w_in", "w_out")}
        x = torch.from_numpy(inp["x"]).requires_grad_(True)
        y, aux = moe_block_a2a(p, x, mesh, n_experts=inp["E"],
                               top_k=inp["K"], capacity_factor=inp["cf"])
        full = y.full_tensor()
        cot = torch.from_numpy(inp["cot"])
        from repro_torch.distributed.moe_a2a import _block
        from repro_torch.distributed.sharding import P
        spec = P("data" if "data" in dims else None, "model", None)
        loss = (y.to_local() * _block(cot, spec, mesh)).sum()
        loss.backward()
        grads = {k: v.grad for k, v in p.items()}
        grads["x"] = x.grad
        for g in grads.values():
            dist.all_reduce(g)
        out[name] = {"y": _np(full), "aux": float(aux),
                     "grads": {k: _np(v) for k, v in grads.items()}}
    return out


def job_pipeline(rank, world, inp):
    """The reference pipeline test's set-up on a (4, 2) ("stage", "data")
    mesh: y, and the gradient of y.sum() for W (summed over the stage
    group) and x."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import make_pipelined_apply
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("stage", "data"))
    W = torch.from_numpy(inp["W"]).requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)

    def stage_fn(params, z, sidx):
        return F.gelu(z @ params, approximate="tanh")

    apply = make_pipelined_apply(stage_fn, mesh, stage_axis="stage")
    y = apply(W, x)
    y.sum().backward()
    group = mesh.get_group("stage")
    # x reaches stage 0 only; W[s] only stage s
    gx = x.grad if x.grad is not None else torch.zeros_like(x)
    for g in (W.grad, gx):
        dist.all_reduce(g, group=group)
    out = {"y": _np(y), "gW": _np(W.grad), "gx": _np(gx)}
    # one stage (every rank its own pipeline): the plain chain's values
    mesh1 = init_device_mesh("cpu", (1, world),
                             mesh_dim_names=("stage", "data"))
    W1 = torch.from_numpy(inp["W"][:1]).requires_grad_(True)
    x1 = torch.from_numpy(inp["x"]).requires_grad_(True)
    y1 = make_pipelined_apply(stage_fn, mesh1)(W1, x1)
    y1.sum().backward()
    W2 = torch.from_numpy(inp["W"][:1]).requires_grad_(True)
    x2 = torch.from_numpy(inp["x"]).requires_grad_(True)
    y2 = stage_fn(W2[0], x2, 0)
    y2.sum().backward()
    out["s1"] = [(_np(a), _np(b)) for a, b in
                 ((y1, y2), (W1.grad, W2.grad), (x1.grad, x2.grad))]
    return out


def _main(job, rank, world, port, tmp):
    import torch.distributed as dist
    tmp = Path(tmp)
    with open(tmp / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = globals()[job](rank, world, inp)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(tmp / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
          sys.argv[5])
