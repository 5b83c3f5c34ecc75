"""Tile shape of the flash-attention kernel (K3): ``csrc/flash_attention.cu``
built in variants and timed at the Zamba2-7B prefill's attention shape.

    PYTHONPATH=src python -m repro_torch.kernels.tune_flash [--seed 0]

Needs a CUDA card.  Inputs: q, k, v of shape (2, 2048, 32, 112), float32,
normal from ``--seed``, causal (one shared-attention call of a Zamba2-7B
prefill at B = 2, L = 2048).  Each variant is the kernel with its block
shape changed: ``kWarps`` warps a block (16 query rows each) and ``kKeys``
keys a staged K/V tile; then ablations of the shipped kernel, each without
one part of its work (its results are then wrong, only the time counts).
For each it prints what ``-Xptxas -v`` reports for the hd = 112 float32
instantiation (registers, spills), the shared memory a block takes, its
time (CUDA events over 10 calls) and its largest difference from the
shipped kernel's output; beside them SDPA's time on the same inputs, as the
yardstick.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build, flash_attention

SHAPE = (2, 2048, 32, 112)
SHAPES = ((4, 32), (8, 16), (8, 32), (8, 64))
_ANCHORS = ("constexpr int kWarps = ", "constexpr int kKeys = ")


# Ablations of the shipped shape: each removes one part of the work (the
# results are then wrong; only the time is read).
_QK = ("      wgmma_row<NS>(s, qh[kk], kh_s + kk * kKeys * 8);\n"
       "      wgmma_row<NS>(s, qh[kk], kl_s + kk * kKeys * 8);\n"
       "      wgmma_row<NS>(s, ql[kk], kh_s + kk * kKeys * 8);\n")
_PV = ("      wgmma_row<KS>(o, ph[j], vh_s + j * HDP * 8);\n"
       "      wgmma_row<KS>(o, ph[j], vl_s + j * HDP * 8);\n"
       "      wgmma_row<KS>(o, pl[j], vh_s + j * HDP * 8);\n")
ABLATIONS = {
    "no Q K^T products": ((_QK, ""),),
    "no P V products": ((_PV, ""),),
    "one TF32 term": ((_QK, _QK.splitlines(keepends=True)[0]),
                      (_PV, _PV.splitlines(keepends=True)[0])),
    "no tile split": (("    split_k<HDP>(kh_s, kl_s, k_raw);\n"
                       "    split_v<HDP>(vh_s, vl_s, v_raw);\n", ""),),
    "no exp": (("        s[j][e] = expf(s[j][e] - mx[e >> 1]);\n",
                "        s[j][e] = s[j][e] - mx[e >> 1];\n"),),
}


def variants(src: str) -> dict:
    """Variant name -> source: one per (warps, keys) in SHAPES, then the
    ablations of the shipped source."""
    lines = src.splitlines(keepends=True)
    at = []
    for anchor in _ANCHORS:
        hits = [i for i, ln in enumerate(lines) if ln.startswith(anchor)]
        if len(hits) != 1:
            raise RuntimeError(f"csrc/flash_attention.cu changed: {anchor!r}")
        at.append(hits[0])
    out = {}
    for warps, keys in SHAPES:
        text = list(lines)
        text[at[0]] = f"{_ANCHORS[0]}{warps};\n"
        text[at[1]] = f"{_ANCHORS[1]}{keys};\n"
        out[f"warps {warps}, keys {keys}"] = "".join(text)
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"csrc/flash_attention.cu changed: {old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(name: str, text: str, out: Path):
    """(library, ptxas report) of one variant."""
    slug = re.sub(r"\W+", "_", name)
    src = _build.CSRC / f"_tune_{slug}.cu"     # beside its headers
    lib = out / f"lib{slug}.so"
    src.write_text(text)
    try:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(lib), str(src)], capture_output=True,
                              text=True)
    finally:
        src.unlink()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    entry, argtypes = _build._ENTRIES["flash_attention"]
    getattr(dll, entry).argtypes = argtypes
    getattr(dll, entry).restype = ctypes.c_int
    return dll, proc.stdout + proc.stderr


def ptxas_line(report: str, ks: int = 14) -> str:
    """Registers and spills of the float32 instantiation with KS k-steps
    (hd 112: KS = 14)."""
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and f"ILi{ks}EfE" in ln:
            tail = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                    if "spill" in x or "Used" in x]
            return "; ".join(tail)
    return "not found"


def events_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash: needs a CUDA card")
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(dev).manual_seed(args.seed)
    q, k, v = (torch.randn(SHAPE, generator=gen, device=dev)
               for _ in range(3))
    want = flash_attention.flash_attention(q, k, v)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = events_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    print(f"K3 at q, k, v {SHAPE} float32, causal; SDPA {sdpa} ms [{card}]",
          flush=True)
    todo = variants((_build.CSRC / "flash_attention.cu").read_text())
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
        built = dict(zip(todo, pool.map(
            lambda kv: build(kv[0], kv[1], Path(tmp)), todo.items())))
        library = flash_attention.library
        try:
            for name, (dll, report) in built.items():
                flash_attention.library = lambda _name, lib=dll: lib
                got = flash_attention.flash_attention(q, k, v)
                diff = float((got - want).abs().max())
                ms = events_ms(lambda: flash_attention.flash_attention(
                    q, k, v), 10)
                shape = ""
                if name.startswith("warps"):
                    warps, keys = (int(w) for w in re.findall(r"\d+", name))
                    # raw K and V tiles and their hi and lo planes
                    smem = 6 * keys * 112 * 4
                    shape = (f"{16 * warps} query rows and {smem} B of "
                             "shared memory a block, ")
                print(f"{name}: {ms} ms ({sdpa / ms:.3f}x SDPA's speed), "
                      f"{shape}max |diff| from the shipped kernel {diff}; "
                      "ptxas "
                      f"(hd 112, float32): {ptxas_line(report)} [{card}]",
                      flush=True)
        finally:
            flash_attention.library = library


if __name__ == "__main__":
    main()
