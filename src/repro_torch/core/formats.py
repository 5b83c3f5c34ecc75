"""Sparse matrix formats for semi-external-memory SpMM.

Implements the paper's storage hierarchy:

* ``COO`` / ``CSR`` — interchange formats (the paper converts *from* CSR).
* ``TiledSCSR`` — the paper's on-SSD format: non-zeros grouped into ``t x t``
  cache tiles stored in row-major tile order; inside each tile, rows with >= 2
  non-zeros use SCSR (a 2-byte row header with the MSB set, followed by 2-byte
  column indices with the MSB clear) and rows with exactly one non-zero use COO
  (row, col) pairs appended behind the SCSR section.  The encoding here is
  byte-exact with the paper's size formula ``S = 2*nnr_multi*? ...`` — see
  :meth:`TiledSCSR.nbytes` — so the Fig-2 SCSR/DCSC comparison reproduces
  exactly, independent of the host machine.
* ``ChunkedTiles`` — the *execution* layout for the device kernels: all
  non-zeros packed into fixed-size chunks, each chunk belonging to exactly one
  tile, with tile-local int32 indices padded to the chunk size.  One CUDA
  thread block takes one chunk; the uint16 SCSR encoding is what streams
  SSD->host.

Tile-local indices fit in 15 bits (max tile size 32K, same constraint as the
paper: the MSB of a uint16 is the row-header flag).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

MAX_TILE = 1 << 15  # paper: MSB of a 2-byte word flags a row header
ROW_FLAG = np.uint16(1 << 15)


# ---------------------------------------------------------------------------
# Interchange formats
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix (host tier, numpy).

    ``vals is None`` denotes a binary matrix (graph adjacency); the paper's
    size formulas use ``c = 0`` bytes per value in that case.
    """

    n_rows: int
    n_cols: int
    rows: np.ndarray  # int64 (n_nnz,)
    cols: np.ndarray  # int64 (n_nnz,)
    vals: Optional[np.ndarray] = None  # (n_nnz,) or None for binary

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def sorted_by_row(self) -> "COO":
        order = np.lexsort((self.cols, self.rows))
        return COO(self.n_rows, self.n_cols, self.rows[order], self.cols[order],
                   None if self.vals is None else self.vals[order])

    def dedup(self) -> "COO":
        """Remove duplicate (row, col) entries (keep first)."""
        if self.vals is None:
            pattern = _dedup_pattern(self.rows, self.cols, self.n_cols)
            if pattern is not None:
                return COO(self.n_rows, self.n_cols, *pattern, None)
        order = _row_major_order(self.rows, self.cols, self.n_cols)
        r, c = self.rows[order], self.cols[order]
        keep = np.ones(r.shape[0], dtype=bool)
        keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        return COO(self.n_rows, self.n_cols, r[keep], c[keep],
                   None if self.vals is None else self.vals[order][keep])

    def transpose(self) -> "COO":
        return COO(self.n_cols, self.n_rows, self.cols.copy(), self.rows.copy(),
                   None if self.vals is None else self.vals.copy())

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        v = np.ones(self.nnz, dtype) if self.vals is None else self.vals.astype(dtype)
        np.add.at(out, (self.rows, self.cols), v)
        return out

    def with_values(self, vals: np.ndarray) -> "COO":
        assert vals.shape[0] == self.nnz
        return COO(self.n_rows, self.n_cols, self.rows, self.cols, vals)


@dataclasses.dataclass
class CSR:
    """Compressed sparse row (the baseline format of MKL / Trilinos)."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray  # int64 (n_rows + 1,)
    indices: np.ndarray  # int64 (n_nnz,)
    vals: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @classmethod
    def from_coo(cls, m: COO) -> "CSR":
        m = m.sorted_by_row()
        counts = np.bincount(m.rows, minlength=m.n_rows)
        indptr = np.zeros(m.n_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(m.n_rows, m.n_cols, indptr, m.cols.copy(),
                   None if m.vals is None else m.vals.copy())

    def to_coo(self) -> COO:
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         np.diff(self.indptr))
        return COO(self.n_rows, self.n_cols, rows, self.indices.copy(),
                   None if self.vals is None else self.vals.copy())

    def nbytes(self, val_bytes: int = 0) -> int:
        """CSR storage: 8-byte indptr per row + 8-byte index per nnz (MKL-like
        64-bit indexing for billion-node graphs) + values."""
        return 8 * (self.n_rows + 1) + 8 * self.nnz + val_bytes * self.nnz


# ---------------------------------------------------------------------------
# TiledSCSR: the paper's format (byte-exact storage + tile statistics)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TileInfo:
    """Per-nonempty-tile statistics, in row-major tile order."""

    tile_ids: np.ndarray    # int64 (n_tiles,) = trow * tiles_per_row + tcol
    nnz: np.ndarray         # int64 (n_tiles,) non-zeros in tile
    nnr_multi: np.ndarray   # rows with >= 2 entries (SCSR section)
    nnr_single: np.ndarray  # rows with exactly 1 entry (COO section)
    nnc: np.ndarray         # non-empty columns (for the DCSC comparison)


@dataclasses.dataclass
class TiledSCSR:
    """The paper's SCSR+COO tiled format.

    ``payload`` is the byte-exact uint16 stream for all tiles concatenated in
    row-major tile order; ``tile_offsets`` indexes it (in uint16 elements).
    Values, when present, are stored in a parallel array in tile order
    (the paper appends ``c``-byte values per non-zero; we keep them in a
    separate array with identical ordering, which has the same byte count).
    """

    n_rows: int
    n_cols: int
    t: int                       # tile size (paper default 16384)
    tile_info: TileInfo
    tile_offsets: np.ndarray     # int64 (n_tiles + 1,) into payload, u16 units
    payload: np.ndarray          # uint16 stream (SCSR headers/cols + COO pairs)
    vals: Optional[np.ndarray]   # (nnz_total,) values in payload entry order
    # Execution-order metadata: entry order inside payload per tile is
    # (multi-entry rows ascending, then single-entry rows ascending).

    @property
    def tiles_per_row(self) -> int:
        return -(-self.n_cols // self.t)

    @property
    def n_tile_rows(self) -> int:
        return -(-self.n_rows // self.t)

    @property
    def nnz(self) -> int:
        return int(self.tile_info.nnz.sum())

    # -- storage accounting (Fig 2 / Fig 8) --------------------------------
    def nbytes(self, val_bytes: int = 0) -> int:
        """Byte-exact SCSR+COO size, matching the paper:
        2 bytes per multi-row header + 2 per column index in SCSR rows,
        4 bytes per COO singleton pair, plus values.

        Note: the paper's formula ``S = 2*nnr + (2+c)*nnz`` counts a 2-byte
        header for every non-empty row; COO singletons also spend exactly
        2 (row) + 2 (col) bytes, so the formula holds for the hybrid too.
        """
        ti = self.tile_info
        nnr = int(ti.nnr_multi.sum() + ti.nnr_single.sum())
        return 2 * nnr + (2 + val_bytes) * self.nnz

    def dcsc_nbytes(self, val_bytes: int = 0) -> int:
        """Paper's DCSC cost model: ``(2+2+4)*nnc + (2+c)*nnz`` per tile."""
        ti = self.tile_info
        return 8 * int(ti.nnc.sum()) + (2 + val_bytes) * self.nnz

    # -- round trip ---------------------------------------------------------
    def to_coo(self) -> COO:
        rows, cols = decode_payload(self)
        return COO(self.n_rows, self.n_cols, rows, cols,
                   None if self.vals is None else self.vals.copy())


def tile_key(rows: np.ndarray, cols: np.ndarray, t: int, tiles_per_row: int):
    return (rows // t) * tiles_per_row + (cols // t)


def _row_major_order(rows: np.ndarray, cols: np.ndarray,
                     n_cols: int) -> np.ndarray:
    """The stable order of entries by (row, col): ``np.lexsort((cols,
    rows))``, computed as one stable argsort of ``row * n_cols + col``
    (several times faster on large graphs) while that key fits int64."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size and (int(rows.max()) + 1) * max(n_cols, 1) >= 2 ** 62:
        return np.lexsort((cols, rows))
    return np.argsort(rows * n_cols + cols, kind="stable")


def _dedup_pattern(rows: np.ndarray, cols: np.ndarray, n_cols: int):
    """A pattern's distinct (row, col) entries in row-major order, by a sort
    of the keys ``row * n_cols + col`` (duplicates carry no value, so which
    one is kept does not matter; several times faster than the stable
    argsort and the gathers).  None where the key does not fit int64."""
    n = max(n_cols, 1)
    if rows.size and (int(rows.max()) + 1) * n >= 2 ** 62:
        return None
    key = np.asarray(rows, np.int64) * n + cols
    key.sort()
    if key.size:
        keep = np.empty(key.size, dtype=bool)
        keep[0] = True
        np.not_equal(key[1:], key[:-1], out=keep[1:])
        key = key[keep]
    return ((key // n).astype(rows.dtype, copy=False),
            (key % n).astype(cols.dtype, copy=False))


def from_coo_tiled(m: COO, t: int = 16384) -> TiledSCSR:
    """Convert COO -> TiledSCSR.  Vectorized numpy; the conversion streams the
    input once and writes the output once (the paper's Table-2 claim: linear
    time, I/O bound)."""
    if t > MAX_TILE:
        raise ValueError(f"tile size {t} exceeds SCSR's 15-bit local index")
    tiles_per_row = -(-m.n_cols // t)

    key = tile_key(m.rows, m.cols, t, tiles_per_row)
    # Sort by (tile, local row, local col): row-major tile order, SCSR row order.
    order = np.lexsort((m.cols, m.rows, key))
    key = key[order]
    r = (m.rows[order] % t).astype(np.int64)
    c = (m.cols[order] % t).astype(np.int64)
    v = None if m.vals is None else m.vals[order]

    # Tile boundaries.
    tile_ids, tile_starts = np.unique(key, return_index=True)
    tile_ends = np.append(tile_starts[1:], key.shape[0])
    tile_nnz = tile_ends - tile_starts
    n_tiles = tile_ids.shape[0]

    # Per-(tile, row) run lengths: a new run starts when tile or local row changes.
    new_run = np.ones(key.shape[0], dtype=bool)
    new_run[1:] = (key[1:] != key[:-1]) | (r[1:] != r[:-1])
    run_starts = np.nonzero(new_run)[0]
    run_ends = np.append(run_starts[1:], key.shape[0])
    run_len = run_ends - run_starts
    run_tile = np.searchsorted(tile_starts, run_starts, side="right") - 1

    multi = run_len >= 2
    nnr_multi = np.bincount(run_tile[multi], minlength=n_tiles).astype(np.int64)
    nnr_single = np.bincount(run_tile[~multi], minlength=n_tiles).astype(np.int64)

    # Non-empty columns per tile (for DCSC size model).
    corder = np.lexsort((c, key))
    ck, cc = key[corder], c[corder]
    newc = np.ones(ck.shape[0], dtype=bool)
    newc[1:] = (ck[1:] != ck[:-1]) | (cc[1:] != cc[:-1])
    col_tile = np.searchsorted(tile_starts, np.nonzero(newc)[0], side="right") - 1
    nnc = np.bincount(col_tile, minlength=n_tiles).astype(np.int64)

    # ---- build the byte-exact uint16 payload ------------------------------
    # Section sizes: SCSR = header + cols per multi-row; COO = 2 u16 per single.
    # Entry order inside a tile: all multi-rows (ascending), then singles.
    # units per tile: sum over multi rows of (1 + len) + 2 * singles
    multi_len_per_tile = np.bincount(run_tile, weights=run_len * multi,
                                     minlength=n_tiles).astype(np.int64)
    units = nnr_multi + multi_len_per_tile + 2 * nnr_single
    tile_offsets = np.zeros(n_tiles + 1, dtype=np.int64)
    np.cumsum(units, out=tile_offsets[1:])
    payload = np.empty(int(tile_offsets[-1]), dtype=np.uint16)

    # Vectorized payload fill via per-run destination offsets.
    # Within a tile: multi runs are laid out first in run order, then singles.
    run_is_multi = multi
    # per-tile cumulative position for multi section
    multi_units = np.where(run_is_multi, run_len + 1, 0)
    single_units = np.where(run_is_multi, 0, 2)
    # exclusive cumsum of units within each tile, in run order
    all_units = multi_units  # multi section first
    # offset of each run inside its tile's multi section:
    cum = np.cumsum(all_units)
    tile_first_run = np.searchsorted(run_tile, np.arange(n_tiles), side="left")
    base = np.where(tile_first_run > 0, cum[tile_first_run - 1], 0)
    multi_off_in_tile = cum - all_units - base[run_tile]
    # singles go after the multi section of their tile:
    multi_section = nnr_multi + multi_len_per_tile
    cum_s = np.cumsum(single_units)
    base_s = np.where(tile_first_run > 0, cum_s[tile_first_run - 1], 0)
    single_off_in_tile = multi_section[run_tile] + (cum_s - single_units - base_s[run_tile])

    run_dst = tile_offsets[run_tile] + np.where(run_is_multi, multi_off_in_tile,
                                                single_off_in_tile)
    # headers (multi) / row ids (single) share the first u16 of each run.
    payload[run_dst] = (r[run_starts].astype(np.uint16)
                        | np.where(run_is_multi, ROW_FLAG, np.uint16(0)))
    # column entries: element e in run k goes to run_dst[k] + 1 + (e - run_starts[k])
    elem_run = np.searchsorted(run_starts, np.arange(key.shape[0]), side="right") - 1
    elem_dst = run_dst[elem_run] + 1 + (np.arange(key.shape[0]) - run_starts[elem_run])
    payload[elem_dst] = c.astype(np.uint16)

    # Values are stored in payload entry order: build the permutation from
    # sorted-entry order to payload order and apply to v.
    vals_out = None
    if v is not None:
        entry_rank = np.empty(key.shape[0], dtype=np.int64)
        # payload order of entries: sort by elem_dst
        entry_rank = np.argsort(elem_dst, kind="stable")
        vals_out = v[entry_rank]

    info = TileInfo(tile_ids=tile_ids, nnz=tile_nnz, nnr_multi=nnr_multi,
                    nnr_single=nnr_single, nnc=nnc)
    return TiledSCSR(m.n_rows, m.n_cols, t, info, tile_offsets, payload, vals_out)


def decode_payload(ts: TiledSCSR) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the uint16 stream back to global (rows, cols), in payload entry
    order (vectorized)."""
    pay = ts.payload
    is_header = (pay & ROW_FLAG) != 0
    unit_tile = np.searchsorted(ts.tile_offsets[1:], np.arange(pay.shape[0]),
                                side="right")
    # SCSR section: header u16s start rows; column u16s inherit the latest header.
    multi_section_end = (ts.tile_offsets[:-1] + ts.tile_info.nnr_multi
                         + _multi_len(ts))
    in_scsr = np.arange(pay.shape[0]) < multi_section_end[unit_tile]

    # SCSR entries: propagate last header index
    hdr_idx = np.where(is_header & in_scsr, np.arange(pay.shape[0]), -1)
    np.maximum.accumulate(hdr_idx, out=hdr_idx)
    scsr_cols_mask = in_scsr & ~is_header
    scsr_rows = (pay[hdr_idx[scsr_cols_mask]] & ~ROW_FLAG).astype(np.int64)
    scsr_cols = pay[scsr_cols_mask].astype(np.int64)
    scsr_tile = unit_tile[scsr_cols_mask]

    # COO section: alternate (row|FLAG? no — singles store plain row, col)
    in_coo = ~in_scsr
    coo_pos = np.arange(pay.shape[0]) - multi_section_end[unit_tile]
    coo_row_mask = in_coo & (coo_pos % 2 == 0)
    coo_col_mask = in_coo & (coo_pos % 2 == 1)
    coo_rows = (pay[coo_row_mask] & ~ROW_FLAG).astype(np.int64)
    coo_cols = pay[coo_col_mask].astype(np.int64)
    coo_tile = unit_tile[coo_col_mask]

    # Reassemble in payload order: entry position = its column-u16 position.
    col_positions = np.concatenate([np.nonzero(scsr_cols_mask)[0],
                                    np.nonzero(coo_col_mask)[0]])
    rows_local = np.concatenate([scsr_rows, coo_rows])
    cols_local = np.concatenate([scsr_cols, coo_cols])
    tiles = np.concatenate([scsr_tile, coo_tile])
    order = np.argsort(col_positions, kind="stable")
    rows_local, cols_local, tiles = rows_local[order], cols_local[order], tiles[order]

    tid = ts.tile_info.tile_ids[tiles]
    trow = tid // ts.tiles_per_row
    tcol = tid % ts.tiles_per_row
    return trow * ts.t + rows_local, tcol * ts.t + cols_local


def _multi_len(ts: TiledSCSR) -> np.ndarray:
    """Column entries in the SCSR (multi-row) section per tile."""
    return ts.tile_info.nnz - ts.tile_info.nnr_single


# ---------------------------------------------------------------------------
# ChunkedTiles: execution layout for the device kernels
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChunkedTiles:
    """Fixed-size-chunk packing of a tiled sparse matrix.

    Every chunk holds ``C`` (padded) non-zeros from exactly one ``T x T``
    tile.  Chunks are ordered by (tile_row, tile_col) so the output block
    for a tile row is visited in one contiguous streak (the paper's
    write-once discipline).  Padding entries have ``val == 0`` and ``row == col == 0``.

    ``meta[:, 0] = tile_row``, ``meta[:, 1] = tile_col``,
    ``meta[:, 2] = 1`` iff the chunk is the first of its tile row.
    Every tile row (including empty ones) has at least one chunk so every
    output block is initialized.
    """

    n_rows: int
    n_cols: int
    T: int
    C: int
    meta: np.ndarray       # int32 (n_chunks, 4); [:,3] = nnz valid in chunk
    row_local: np.ndarray  # int32 (n_chunks, C)
    col_local: np.ndarray  # int32 (n_chunks, C)
    vals: np.ndarray       # float32/bf16 (n_chunks, C)

    @property
    def n_chunks(self) -> int:
        return int(self.meta.shape[0])

    @property
    def n_tile_rows(self) -> int:
        return -(-self.n_rows // self.T)

    @property
    def padded_rows(self) -> int:
        return self.n_tile_rows * self.T

    @property
    def padded_cols(self) -> int:
        return (-(-self.n_cols // self.T)) * self.T

    def nbytes(self) -> int:
        return (self.meta.nbytes + self.row_local.nbytes + self.col_local.nbytes
                + self.vals.nbytes)


def to_chunked(m: COO, T: int = 16384, C: int = 2048,
               dtype=np.float32) -> ChunkedTiles:
    """Pack a COO matrix into ChunkedTiles (vectorized)."""
    tiles_per_row = -(-m.n_cols // T)
    n_tile_rows = -(-m.n_rows // T)
    key = tile_key(m.rows, m.cols, T, tiles_per_row)
    # entries by (tile, row, col): tile-major order is row-major order in
    # the (tile, local row) x (local col) grid
    order = _row_major_order(key.astype(np.int64) * T + m.rows % T,
                             m.cols % T, T)
    key = key[order]
    r = (m.rows[order] % T).astype(np.int32)
    c = (m.cols[order] % T).astype(np.int32)
    v = (np.ones(m.nnz, dtype) if m.vals is None else m.vals[order].astype(dtype))

    # key is sorted: each tile's entries are one run
    new_tile = np.ones(key.shape[0], dtype=bool)
    np.not_equal(key[1:], key[:-1], out=new_tile[1:])
    tile_starts = np.flatnonzero(new_tile)
    tile_ids = key[tile_starts]
    tile_nnz = np.append(tile_starts[1:], key.shape[0]) - tile_starts
    chunks_per_tile = -(-tile_nnz // C)

    trow_of_tile = (tile_ids // tiles_per_row).astype(np.int64)
    # Tile rows that have no tiles at all still need one zero chunk.
    present = np.zeros(n_tile_rows, dtype=bool)
    present[trow_of_tile] = True
    n_empty = int((~present).sum())

    n_chunks = int(chunks_per_tile.sum()) + n_empty
    meta = np.zeros((n_chunks, 4), dtype=np.int32)
    row_l = np.zeros((n_chunks, C), dtype=np.int32)
    col_l = np.zeros((n_chunks, C), dtype=np.int32)
    vals = np.zeros((n_chunks, C), dtype=dtype)

    # Destination of each entry in the flattened (chunk, slot) grid: a
    # tile's entries fill its chunks in order, slot by slot.
    chunk_base = np.zeros(tile_ids.shape[0], dtype=np.int64)
    np.cumsum(chunks_per_tile[:-1], out=chunk_base[1:])
    # interleave empty tile-row chunks: place them after all real chunks, then
    # sort meta by (tile_row, tile_col) at the end.
    dest = np.repeat(chunk_base * C - tile_starts, tile_nnz)
    dest += np.arange(key.shape[0])
    row_l.reshape(-1)[dest] = r
    col_l.reshape(-1)[dest] = c
    vals.reshape(-1)[dest] = v

    n_real = int(chunks_per_tile.sum())
    chunk_tile = np.searchsorted(chunk_base, np.arange(n_real), side="right") - 1
    meta[:n_real, 0] = trow_of_tile[chunk_tile]
    meta[:n_real, 1] = (tile_ids % tiles_per_row)[chunk_tile]
    within_chunk_idx = np.arange(n_real) - chunk_base[chunk_tile]
    meta[:n_real, 3] = np.minimum(tile_nnz[chunk_tile] - within_chunk_idx * C, C)
    if n_empty:
        meta[n_real:, 0] = np.nonzero(~present)[0].astype(np.int32)
        meta[n_real:, 1] = 0
        meta[n_real:, 3] = 0

    # Final order: (tile_row, tile_col, chunk index) — already true for real
    # chunks; stable-sort to slot empty-row chunks into place.
    if n_empty:
        final = np.lexsort((np.arange(n_chunks), meta[:, 1], meta[:, 0]))
        meta, row_l, col_l, vals = (meta[final], row_l[final], col_l[final],
                                    vals[final])

    # First-of-tile-row flags.
    meta[0, 2] = 1
    meta[1:, 2] = (meta[1:, 0] != meta[:-1, 0]).astype(np.int32)
    return ChunkedTiles(m.n_rows, m.n_cols, T, C, meta, row_l, col_l, vals)


# ---------------------------------------------------------------------------
# Per-chunk uint8 delta encoding (the optimized TileStore's packed planes)
# ---------------------------------------------------------------------------
# A chunk's encoding tag is a 2-bit plane-width mask: bit 0 set -> the row
# plane is stored as uint8, bit 1 set -> the column plane is stored as
# uint8 (an unset bit keeps the raw uint16 width).  The widths drive the
# byte layout mechanically (``TileStore._rec_of``); the *meaning* of the
# packed planes is a single scheme:
ENC_ROWS_U8 = 1
ENC_COLS_U8 = 2
ENC_FLAT_U24 = ENC_COLS_U8              # u16 + u8 planes: 24-bit deltas
ENC_FLAT_U16 = ENC_ROWS_U8 | ENC_COLS_U8  # u8 + u8 planes: 16-bit deltas

# Flattened-key delta encoding (entries are sorted by (row, col) within a
# chunk, so the flattened key k = row * T + col is non-decreasing — the
# standard sorted-edge-list delta idiom):
#
#   dk[i] = k[i] - k[i-1]           (dk[0] = 0)
#   rows plane stores dk >> 8, cols plane stores dk & 255
#   meta[:, 4:6] = (row[0], col[0]) reconstruct the base key.
#
# ENC_FLAT_U16 packs the high byte as uint8 (2 B/lane, every gap fits 16
# bits); ENC_FLAT_U24 keeps it uint16 (3 B/lane, gaps up to 2**24 - 1).
# Since a gap never exceeds T*T - 1, every chunk with T <= 4096 packs in
# one of the two modes — there is no raw fallback at the bench tile
# sizes, which is what keeps the encoding-run fragmentation low.  A
# 24-bit-mode chunk costs what a per-plane "row deltas only" mode would
# (3 B/lane) while covering strictly more chunks, so per-plane modes
# earn no slot.
#
# The column plane's dtype identifies packing (u8 -> flattened deltas,
# u16 -> raw), and the row plane's dtype the delta width, so decoders
# dispatch with no side channel and one shared reconstruction:
# dk = rows << 8 | cols in either packed mode.  Padding lanes store 0 and
# decode to 0 (masked by chunk nnz), reproducing the raw planes exactly,
# so a packed chunk is bit-identical to its raw form through any engine.


def encode_chunk_planes(meta: np.ndarray, row_l: np.ndarray,
                        col_l: np.ndarray, T: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Per-chunk packability test + packed planes (vectorized).

    Returns ``(tags, bases, rows_hi, cols_lo)``: ``tags`` uint8 (n,) — the
    chosen ENC_* mode per chunk (16-bit deltas preferred, then 24-bit,
    else 0 = raw) — ``bases`` int32 (n, 2) = (row[0], col[0]) per chunk,
    ``rows_hi`` uint16 (n, C) = dk >> 8 (the writer narrows it to uint8
    where the 16-bit mode applies) and ``cols_lo`` uint8 (n, C) =
    dk & 255.  Both planes are meaningful only where the tag is nonzero.
    """
    n, C = row_l.shape
    nnz = meta[:, 3].astype(np.int64)
    lanes = np.arange(C)[None, :]
    valid = lanes < nnz[:, None]
    r = row_l.astype(np.int64)
    c = col_l.astype(np.int64)
    k = r * T + c
    dk = np.where(valid, k - np.concatenate([k[:, :1], k[:, :-1]], axis=1), 0)
    dk[:, 0] = 0
    sorted_ok = (dk >= 0).all(axis=1)
    ok16 = sorted_ok & (dk <= 65535).all(axis=1)
    ok24 = sorted_ok & (dk <= (1 << 24) - 1).all(axis=1)
    tags = np.where(ok16, ENC_FLAT_U16,
                    np.where(ok24, ENC_FLAT_U24, 0)).astype(np.uint8)
    dk = np.where(tags[:, None] != 0, dk, 0)
    rows_hi = (dk >> 8).astype(np.uint16)
    cols_lo = (dk & 255).astype(np.uint8)
    bases = np.stack([row_l[:, 0], col_l[:, 0]], axis=1).astype(np.int32)
    bases[nnz == 0] = 0
    return tags, bases, rows_hi, cols_lo


def decode_packed_planes(meta: np.ndarray, rows: np.ndarray,
                         cols: np.ndarray, T: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side mirror of the device decode (integer-exact, so the
    decoded-i32 cache/IM paths match the device paths bitwise).  The
    plane dtypes select the mode (see the encoding comment above);
    ``meta`` must carry the bases (width >= 6) whenever a plane arrives
    as uint8.  Returns int32 planes with padding lanes zeroed — exactly
    the raw planes the encoder consumed.
    """
    C = rows.shape[1]
    lanes = np.arange(C)[None, :]
    if cols.dtype == np.uint8:   # flattened deltas (16- or 24-bit dk)
        dk = (rows.astype(np.int64) << 8) | cols.astype(np.int64)
        k = (meta[:, 4:5].astype(np.int64) * T
             + meta[:, 5:6].astype(np.int64) + np.cumsum(dk, axis=1))
        r = k // T
        c = k - r * T
    else:
        r = rows.astype(np.int64)
        c = cols.astype(np.int64)
    valid = lanes < meta[:, 3:4]
    r = np.where(valid, r, 0)
    c = np.where(valid, c, 0)
    return r.astype(np.int32), c.astype(np.int32)


def chunked_from_tiled(ts: TiledSCSR, C: int = 2048,
                       dtype=np.float32) -> ChunkedTiles:
    """Decode TiledSCSR (the storage format) into the execution layout."""
    rows, cols = decode_payload(ts)
    coo = COO(ts.n_rows, ts.n_cols, rows, cols, ts.vals)
    return to_chunked(coo, T=ts.t, C=C, dtype=dtype)
