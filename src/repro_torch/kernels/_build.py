"""Build and load the port's CUDA kernels from the sources in this package.

Each ``csrc/*.cu`` file has a plain C interface and no PyTorch headers, so
``nvcc`` builds it into a shared library in seconds; the library is loaded
with :mod:`ctypes`.  Libraries go to ``build/torch_ext/`` at the root of the
checkout, named by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags: a changed source builds anew, an unchanged one is loaded as
it is.  A failed build raises.  :func:`build_all` starts one ``nvcc`` per
source, all at once.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float   # 0.0 when an up-to-date library was found
    ptxas: str       # what ``-Xptxas -v`` reported when it was built


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(nvcc)


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` for sm_90a unless an up-to-date library
    exists.  Returns where it is and what the compiler reported."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return BuildInfo(name, lib, 0.0, log.read_text())
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)
    return BuildInfo(name, lib, seconds, report)


SOURCES = ("sem_spmm", "sem_spmm_mxu", "flash_attention", "ssd_chunk")


def build_all() -> Dict[str, BuildInfo]:
    """Build every kernel source, one ``nvcc`` each, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


_P, _I, _Q, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The chunk-batch kernels' signature (sem_spmm_mxu.cu); the gather kernel's
# adds an int, ``fresh``, before the stream (sem_spmm.cu).
_BATCH = [_P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _Q, _I, _I, _I, _I,
          _P]
# C signature of each source's entry point.
_ENTRIES = {
    "sem_spmm": ("sem_spmm_batch", _BATCH[:-1] + [_I, _P]),
    "sem_spmm_mxu": ("sem_spmm_mxu_batch", _BATCH),
    "flash_attention": ("flash_attention_fwd", [_P, _P, _P, _P, _I, _I, _I,
                                                _I, _I, _I, _I, _F, _F, _I,
                                                _P]),
    "ssd_chunk": ("ssd_chunk_fwd", [_P] * 11 + [_I] * 7 + [_P]),
}


_COUNT_LOCK = threading.Lock()


def count_launch(launches: Dict[str, int], key: str) -> None:
    """Add one to a wrapper's launch count, under a lock: a bare ``+=``
    from several threads launching at once can drop counts."""
    with _COUNT_LOCK:
        launches[key] += 1


_LIBRARIES: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu``, built at first use, with the C signature of its
    entry point declared.  Loaded under a lock: threads that launch a
    kernel for the first time together (the shards of a sharded scan)
    build and load it once."""
    with _LOAD_LOCK:
        lib = _LIBRARIES.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name).path))
            entry, argtypes = _ENTRIES[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBRARIES[name] = lib
        return lib
