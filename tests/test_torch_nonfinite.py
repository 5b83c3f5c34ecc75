"""Non-finite operands through the port's SpMM kernels' plain versions,
held to the JAX package's default jnp path NaN for NaN.

The contract is the reference's ``core/spmm.py::spmm_chunked`` (the scan of
``_spmm_chunked_impl``, which the engine's ``_batch_step`` runs under
``use_pallas=False``): pad lanes are masked, and a NaN or inf reaches only
the output rows whose live lanes meet a non-finite product.  The input: an
R-MAT graph (scale 10, edge factor 8, seed 1) with integer values in
[-3, 3], chunked at T = 256, C = 64 (16 chunks have pad lanes), and an
operand of integers in [-4, 4] with ``x[0, 0] = inf``.  Integer data makes
every finite sum exact, so the comparison is bit for bit.

The reference's Pallas kernels differ from this contract on such inputs
(its gather body multiplies pad lanes' value 0 by X, its mxu body spreads
NaN over a tile row), so they are not the yardstick here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.formats import to_chunked as ref_to_chunked
from repro.core.spmm import spmm_chunked as ref_spmm_chunked
from repro.sparse.generate import rmat as ref_rmat
from repro_torch.convert import chunked_from_arrays
from repro_torch.kernels import sem_spmm
from repro_torch.kernels.ops import spmm_kernel

T, C = 256, 64


@pytest.fixture(scope="module")
def case():
    """(reference ChunkedTiles, x, the reference's default-path result)."""
    g = ref_rmat(10, 8, seed=1)
    rng = np.random.default_rng(11)
    gv = g.with_values(rng.integers(-3, 4, g.nnz).astype(np.float32))
    ct = ref_to_chunked(gv, T=T, C=C)
    x = rng.integers(-4, 5, (gv.n_cols, 2)).astype(np.float32)
    x[0, 0] = np.inf
    want = np.asarray(ref_spmm_chunked(ct, jnp.asarray(x)))
    return ct, x, want


def test_input_has_the_shape_of_the_fault(case):
    """The premise: pad lanes exist, and the result has NaN and inf in
    column 0 of some rows only (a densify that spreads them fills every
    row of the four tile rows)."""
    ct, _, want = case
    assert (ct.meta[:, 3] < C).sum() == 16
    bad = ~np.isfinite(want)
    assert np.isnan(want).sum() == 28 and bad.any()
    assert bad[:, 1].sum() == 0 and bad[:, 0].sum() < want.shape[0] // 4


@pytest.mark.parametrize("variant", ["gather", "mxu"])
@pytest.mark.parametrize("how", ["batches", "one_shot", "spmm_kernel"])
def test_plain_versions_match_reference_nan_for_nan(case, variant, how):
    """Chunk batches of 37 through ``spmm_tiles_acc_plain`` /
    ``spmm_tiles_acc_mxu_plain`` (so batches start inside tile rows), the
    one-shot ``spmm_tiles`` on CPU tensors, and ``spmm_kernel`` with
    ``device="cpu"``: each equal to the reference, NaN for NaN."""
    ct, x, want = case
    x_pad = np.zeros((ct.padded_cols, 2), np.float32)
    x_pad[: x.shape[0]] = x
    planes = [torch.from_numpy(a) for a in (ct.meta, ct.row_local,
                                            ct.col_local, ct.vals)]
    xp = torch.from_numpy(x_pad)
    if how == "batches":
        acc = torch.zeros((ct.n_tile_rows * T, 2))
        for s in range(0, ct.n_chunks, 37):
            meta, rows, cols, vals = (a[s:s + 37] for a in planes)
            nv = torch.tensor([meta.shape[0]], dtype=torch.int32)
            sem_spmm._PLAIN[variant](meta, nv, rows, cols, vals, xp, acc,
                                     T=T)
        got = acc.numpy()[: ct.n_rows]
    elif how == "one_shot":
        got = sem_spmm.spmm_tiles(*planes, xp, T=T,
                                  n_tile_rows=ct.n_tile_rows,
                                  variant=variant).numpy()[: ct.n_rows]
    else:
        port_ct = chunked_from_arrays(ct.n_rows, ct.n_cols, ct.T, ct.C,
                                      ct.meta, ct.row_local, ct.col_local,
                                      ct.vals)
        got = spmm_kernel(port_ct, x, variant=variant, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_densify_plain_routes_non_finite_values(case):
    """A non-finite stored value (not only X) is routed the same way: the
    densify plain version equals the gather one, NaN for NaN, with X
    finite and one value inf and one NaN."""
    ct, x, _ = case
    vals = ct.vals.copy()
    vals[3, 0], vals[40, 5] = np.inf, np.nan
    x_pad = np.zeros((ct.padded_cols, 2), np.float32)
    x_pad[: x.shape[0]] = np.where(np.isfinite(x), x, 2.0)
    out = []
    for variant in ("gather", "mxu"):
        out.append(sem_spmm.spmm_tiles(
            *(torch.from_numpy(a) for a in (ct.meta, ct.row_local,
                                            ct.col_local, vals)),
            torch.from_numpy(x_pad), T=T, n_tile_rows=ct.n_tile_rows,
            variant=variant).numpy())
    assert not np.isfinite(out[0]).all()
    assert (~np.isfinite(out[0])).sum() <= 4
    np.testing.assert_array_equal(out[1], out[0])
