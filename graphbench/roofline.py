"""Published peaks of one NVIDIA H100 SXM and the work counts the roofline
shares divide by.

Peaks (NVIDIA's data sheet, SXM part, at the full 700 W): HBM3 at 3.35 TB/s,
67 TFLOP/s float32 outside the tensor cores, and the PCIe 5.0 x16 host link
at 64 GB/s a direction.

A product's least time is ``max(bytes / HBM, flops / FP32)``, as
``chip_smoke.py::bound`` computes it.  The bytes are what the inputs need,
read once, and the output written once: the live lanes of the matrix's
planes in the store's format (its meta record per chunk, its index and
value widths per stored entry), the operand's ``n_cols x p`` float32
elements and the output's ``n_rows x p``.  Padding lanes are not counted:
no kernel has to read them, so no kernel can beat the bound.  The flops are
``2 * nnz * p``.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
PCIE_BYTES_PER_S = 64e9


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds on the card: bytes over HBM or flops over float32
    peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def link_s(nbytes: float) -> float:
    """Least seconds for ``nbytes`` to cross the host link one way."""
    return nbytes / PCIE_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class MatrixWork:
    """What one product over a stored sparse matrix must touch."""
    n_rows: int
    n_cols: int
    nnz: int
    n_chunks: int
    meta_bytes: int      # one chunk's meta record
    lane_bytes: int      # one stored entry's index (and value) bytes

    def product(self, p: int):
        """(bytes, flops) of ``A @ X`` with X of width ``p``."""
        nbytes = (self.n_chunks * self.meta_bytes + self.nnz * self.lane_bytes
                  + 4 * p * (self.n_cols + self.n_rows))
        return nbytes, 2 * self.nnz * p


def store_work(header: dict, nnz: int) -> MatrixWork:
    """The work of a raw ``TileStore`` from its header: a chunk record is
    ``4 * meta_ints`` bytes of meta, then ``C`` lanes of each plane."""
    meta = 4 * int(header.get("meta_ints", 4))
    lane = (int(header["record"]) - meta) // int(header["C"])
    return MatrixWork(int(header["n_rows"]), int(header["n_cols"]), nnz,
                      int(header["n_chunks"]), meta, lane)


def raw_store_work(n_rows: int, n_cols: int, nnz: int, n_chunks: int,
                   binary: bool) -> MatrixWork:
    """The same matrix in a raw store's format (int32[4] meta, uint16 row
    and column, float32 value unless binary), for a matrix held only in
    memory."""
    return MatrixWork(n_rows, n_cols, nnz, n_chunks, 16,
                      4 + (0 if binary else 4))
