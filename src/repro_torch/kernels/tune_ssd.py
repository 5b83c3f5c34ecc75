"""Where the SSD chunk kernel's time goes: ``csrc/ssd_chunk.cu`` (K4) built
in variants and timed at the two full-width prefill shapes.

    PYTHONPATH=src python -m repro_torch.kernels.tune_ssd [--seed 0]
        [--source path/to/ssd_chunk.cu] [--only name,name]

Needs a CUDA card.  Inputs: the first Mamba layer's SSD call of a prefill
at B = 2, L = 2048, Q = 256, float32, in the shapes of Zamba2-7B (H = 112,
dh = 64, N = 64) and Mamba2-130M (H = 24, dh = 64, N = 128), made from
``--seed`` with the models' statistics at their default init: x, B and C
silu of a normal, dt softplus of a normal (about 0.7), A = -1, D = 1.
Each variant's time is the median of 5 timings, each CUDA events over 10
calls.

Each variant is the source with one thing changed (a variant whose anchor
the source lacks is skipped, so ``--source`` can time an earlier version
of the kernel, for instance the parent commit's; its own headers are
looked up beside it):

* before the redesign (one block per (batch, head) walking the chunks):
  ``return at once`` (the launch floor), ``C B^T a constant``, ``no
  expf`` and ``no state update``;
* the chunk-parallel kernel: ``(a) alone``, ``(b) alone``, ``(c) alone``
  and ``(d) alone`` (one of its four launches; the others' workspaces are
  left as they are), ``one TF32 term`` (a single TF32 product in place of
  the three-term split), ``cvt split`` (the split by the conversion
  instruction, ``tf32_mma.cuh::split_tf32``, in place of the integer one),
  ``constant decay`` (no exp in the scan's weights) and ``expf decay``
  (``expf`` in place of ``__expf`` there); and the scan (d) alone without
  parts of its work: ``(d) staging and split only`` (no products, and so
  no A values or weights), ``(d) no split`` (the B planes left as they
  are) and ``(d) no further tiles`` (only the first two B tiles staged).

Only ``as given`` computes the function; its largest difference from the
plain version is shown.  Beside the times: the registers and spills
``-Xptxas -v`` reports for each float32 kernel, and the bounds.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ssd_chunk

SHAPES = {"zamba2-7b": (2, 2048, 112, 64, 64),
          "mamba2-130m": (2, 2048, 24, 64, 128)}
Q = 256
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12       # H100 SXM, dense TF32 on the tensor cores

_OLD_KERNEL_START = ("  const int h = blockIdx.x;\n"
                     "  const int b = blockIdx.y;\n")
_OLD_CBT = "        fma_abt<4>(sc, c_s, kLdN, b_s, kLdN, NP, r0, tx);\n"
_OLD_UPDATE = ("    float ds[4][kNJ] = {};\n"
               "    for (int j0 = 0; j0 < Q; j0 += kTileRows) {\n")
_LAUNCHES = {"(a)": "  ssd_chunk_cbt<T, NPT><<<",
             "(b)": "  ssd_chunk_states<T><<<",
             "(c)": "  ssd_chunk_pass<<<",
             "(d)": "  ssd_chunk_scan<T><<<"}
_TERMS = ("  mma_tf32(d, ah, h0, h1);\n  mma_tf32(d, ah, l0, l1);\n"
          "  mma_tf32(d, al, h0, h1);\n")
_WG_LO = ("    wgmma64(acc, ah[kk], wgmma_desc(lo + 512 * kk));\n"
          "    wgmma64(acc, al[kk], wgmma_desc(hi + 512 * kk));\n")
_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
          "0xffffe000u;\n")
# the scan (d) alone, and without parts of its work
_D_ONLY = [(anchor, anchor.replace("  ", "  if (false) ", 1))
           for step, anchor in _LAUNCHES.items() if step != "(d)"]
_D_SPLIT = ("    if (u < S)\n"
            "      split_b<float, LDS, false>(hi_s, lo_s,\n"
            "                                 reinterpret_cast<const float*>"
            "(buf),\n"
            "                                 nullptr);\n"
            "    else\n"
            "      split_b<T, LDX, false>(hi_s, lo_s, reinterpret_cast<const "
            "T*>(buf),\n"
            "                             nullptr);\n")
_D_PRODUCTS = ("    wgmma_tile(acc, a, hi_s, lo_s, "
               "[&](float (&next)[8][4]) {\n"
               "      if (u + 1 < n_tiles) load_a(next, u + 1);\n"
               "    });\n")
VARIANTS = [
    ("return at once", [(_OLD_KERNEL_START,
                         "  if (threadIdx.x < 1u << 30) return;\n"
                         + _OLD_KERNEL_START)]),
    ("C B^T a constant", [(_OLD_CBT,
                           "        for (auto& r : sc)\n"
                           "          for (float& v : r) v = 1.0f;\n")]),
    ("no expf", [("expf(cum_s[ri] - cum_s[cj])", "(cum_s[ri] - cum_s[cj])"),
                 ("expf(cum_s[ri]);", "cum_s[ri];"),
                 ("expf(total - cum_s[row])", "(total - cum_s[row])"),
                 ("expf(total);", "total;")]),
    ("no state update", [(_OLD_UPDATE,
                          _OLD_UPDATE.replace("j0 < Q", "j0 < 0"))]),
    *((f"{step} alone", [(anchor, anchor.replace("  ", "  if (false) ", 1))
                         for other, anchor in _LAUNCHES.items()
                         if other != step]) for step in _LAUNCHES),
    ("one TF32 term", [(_TERMS, _TERMS.splitlines(keepends=True)[0]),
                       (_WG_LO, "")]),
    ("cvt split", [(_SPLIT, "  split_tf32(x, hi, lo);\n")]),
    ("constant decay", [(f"__expf(cum{r} - cj.{c}) * ", "")
                        for r in (0, 1) for c in ("x", "z")]),
    ("expf decay", [(f"__expf(cum{r} - cj.{c})", f"expf(cum{r} - cj.{c})")
                    for r in (0, 1) for c in ("x", "z")]),
    ("(d) staging and split only", _D_ONLY + [(_D_PRODUCTS, "")]),
    ("(d) no split", _D_ONLY + [(_D_SPLIT, "")]),
    ("(d) no further tiles", _D_ONLY + [("    stage_tile(u + 2);\n",
                                         "    cp_async_commit();\n")]),
]


def variants(src: str) -> dict:
    """Variant name -> source: the source as given, then each variant whose
    anchors it holds once each."""
    out = {"as given": src}
    for name, edits in VARIANTS:
        if all(src.count(a) == 1 for a, _ in edits):
            text = src
            for a, b in edits:
                text = text.replace(a, b)
            out[name] = text
    return out


def build(name: str, text: str, include: Path, out: Path):
    """(entry point, whether it takes workspaces, ptxas report) of one
    variant."""
    slug = re.sub(r"\W+", "_", name)
    src = _build.CSRC / f"_tune_ssd_{slug}.cu"     # beside its headers
    lib = out / f"lib{slug}.so"
    src.write_text(text)
    try:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                               f"-I{include}", "-o", str(lib), str(src)],
                              capture_output=True, text=True)
    finally:
        src.unlink()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).ssd_chunk_fwd
    work = "void* cbt" in text
    _, argtypes = _build._ENTRIES["ssd_chunk"]
    # before the workspaces: no cbt, states, cd pointers
    fn.argtypes = argtypes if work else argtypes[:8] + argtypes[11:]
    fn.restype = ctypes.c_int
    return fn, work, proc.stdout + proc.stderr


def ptxas_lines(report: str) -> str:
    """Registers and spills of each float32 kernel."""
    lines = report.splitlines()
    out = []
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if not m or "13__nv_bfloat16" in m.group(1):
            continue
        kernel = re.search(r"ssd_chunk_\w+?(?=I|P|E|$)|ssd_chunk_kernel",
                           m.group(1))
        tail = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                if "spill" in x or "Used" in x]
        out.append(f"{kernel.group(0) if kernel else m.group(1)}: "
                   + "; ".join(tail))
    return " | ".join(out)


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def inputs(shape, seed: int, dev):
    B, L, H, dh, N = shape
    gen = torch.Generator(dev).manual_seed(seed)

    def normal(*s):
        return torch.randn(s, generator=gen, device=dev)
    x = F.silu(normal(B, L, H, dh))
    dt = F.softplus(normal(B, L, H))
    A = -torch.ones(H, device=dev)
    Bm, Cm = F.silu(normal(B, L, N)), F.silu(normal(B, L, N))
    D = torch.ones(H, device=dev)
    return x, dt, A, Bm, Cm, D


def bounds(shape) -> str:
    """The function's bounds (chip_smoke.py's ssd_flops and bytes)."""
    B, L, H, dh, N = shape
    tri, nc = Q * (Q + 1) // 2, L // Q
    flops = (B * nc * 2 * N * tri
             + B * H * nc * (2 * dh * tri + 4 * Q * N * dh + 2 * Q * dh))
    nbytes = 4 * (2 * B * L * H * dh + B * L * H + 2 * H + 2 * B * L * N
                  + B * H * dh * N)
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (f"bound {max(mem, 3 * flops / TF32_FLOPS_PER_S * 1e3)} ms on the "
            f"tensor cores (3 x {flops / 1e9:.2f} GFLOP TF32), "
            f"{max(mem, flops / FP32_FLOPS_PER_S * 1e3)} ms on the CUDA "
            f"cores, {mem} ms for {nbytes} B")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", type=Path,
                    default=_build.CSRC / "ssd_chunk.cu",
                    help="kernel source to time (default: the shipped one)")
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_ssd: needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cells = {arch: inputs(shape, args.seed, dev)
             for arch, shape in SHAPES.items()}
    want = {arch: ssd_chunk.ssd_chunked_plain(*ins, Q=Q)
            for arch, ins in cells.items()}
    print(f"K4 at Q = {Q}, float32; source {args.source} [{card}]",
          flush=True)
    for arch, shape in SHAPES.items():
        print(f"  {arch}: (B, L, H, dh, N) = {shape}; {bounds(shape)}",
              flush=True)

    todo = variants(args.source.read_text())
    if args.only:
        keep = {"as given", *args.only.split(",")}
        todo = {k: v for k, v in todo.items() if k in keep}
    print("variants: " + ", ".join(todo), flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: build(kv[0], kv[1], args.source.resolve().parent,
                             Path(tmp)), todo.items())))
        print("ptxas (float32): " + ptxas_lines(built["as given"][2]),
              flush=True)
        for name, (fn, work, _) in built.items():
            parts = []
            for arch, ins in cells.items():
                B, L, H, dh, N = SHAPES[arch]
                y = torch.empty_like(ins[0])
                state = torch.empty((B, H, dh, N), device=dev)
                ws = [torch.empty(s, device=dev) for s in
                      ssd_chunk.workspace_shapes(B, L, H, dh, N, Q)]
                ptrs = [t.data_ptr() for t in (*ins, y, state)]
                if work:
                    ptrs += [t.data_ptr() for t in ws]

                def call():
                    err = fn(*ptrs, B, L, H, dh, N, Q, 0, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms = np.median([events_ms(call, 10) for _ in range(5)])
                cell = f"{arch} {ms} ms"
                if name == "as given":
                    diff = max(float((got - w).abs().max())
                               for got, w in zip((y, state), want[arch]))
                    cell += f" (max |diff| from the plain version {diff})"
                parts.append(cell)
            print(f"{name}: " + "; ".join(parts) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
