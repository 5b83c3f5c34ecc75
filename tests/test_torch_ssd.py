"""The port's SSD chunked scan (K4) on the CPU: its plain version against the
JAX package's Pallas kernel in interpret mode and the reference's jnp scan,
the kernel's chunk-parallel decomposition (``csrc/ssd_chunk.cu``, written
here in plain torch) against both, chunk invariance, the hand-off of the
final state to the decode step, and the port's ``models/ssm.py::
ssd_chunked`` with a carried-in state.

Tolerance is the reference's own (``tests/test_ssd_kernel.py``):
``rtol = atol = 2e-4``, ``1e-4`` for chunk invariance and ``2e-3`` for the
prefill-to-decode hand-off.  Both sides work in float32 and sum in other
orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.ssd_chunk import ssd_chunked_tpu
from repro.models import ssm as ref_ssm
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.models import ssm

TOL = 2e-4


def _inputs(B, L, H, dh, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, H, dh)).astype(np.float32),
            rng.uniform(0.001, 0.1, (B, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32),
            rng.standard_normal((B, L, N)).astype(np.float32),
            rng.standard_normal((H,)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,L,H,dh,N,Q", [
    (1, 256, 2, 32, 16, 128),
    (2, 256, 4, 64, 32, 128),
    (1, 512, 2, 64, 64, 256),
    (1, 128, 1, 16, 8, 128),   # single chunk
    (1, 256, 2, 64, 128, 128),  # Mamba2-130M's state size and head dim
])
def test_plain_matches_pallas_and_jnp(B, L, H, dh, N, Q):
    ins = _inputs(B, L, H, dh, N, seed=L + H + N)
    k4.reset_launches()
    y, s = k4.ssd_chunked(*_t(ins), Q=Q)
    assert k4.LAUNCHES["ssd_chunked"] == 0           # plain on the CPU
    y_k, s_k = ssd_chunked_tpu(*_j(ins), Q=Q)
    y_r, s_r = ref_ssm.ssd_chunked(*_j(ins), chunk=Q)
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=TOL,
                                   atol=TOL)


def _decomposed(x, dt, A, Bm, Cm, D, Q):
    """The CUDA kernel's four steps in plain torch, float32: (a) C Bᵀ once
    per (batch, chunk); (b) cum and each chunk's own state U_c = Σ_j
    exp(total - cum_j) dt_j x_j B_jᵀ; (c) the states carried in, s_c =
    exp(total_{c-1}) s_{c-1} + U_{c-1} from s_0 = 0, and the final state;
    (d) y = (G ⊙ W) x + exp(cum_i) C_i s_cᵀ + D x with W_ij = exp(cum_i -
    cum_j) dt_j below the diagonal (0 above it before any exp)."""
    Bb, L, H, dh = x.shape
    N, nc = Bm.shape[-1], L // Q
    xq = x.reshape(Bb, nc, Q, H, dh)
    dtq = dt.reshape(Bb, nc, Q, H)
    bq, cq = Bm.reshape(Bb, nc, Q, N), Cm.reshape(Bb, nc, Q, N)
    G = cq @ bq.transpose(-1, -2)                                  # (a)
    cum = torch.cumsum(dtq * A, dim=2)                             # (b)
    total = cum[:, :, -1]                                          # (B, nc, H)
    w = torch.exp(total[:, :, None] - cum) * dtq
    U = torch.einsum("bcjh,bcjhd,bcjn->bchdn", w, xq, bq)
    s_in, s = [], torch.zeros((Bb, H, dh, N))                      # (c)
    for c in range(nc):
        s_in.append(s)
        s = torch.exp(total[:, c])[..., None, None] * s + U[:, c]
    lower = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[..., None]
    diff = cum[:, :, :, None] - cum[:, :, None, :]                 # (d)
    W = torch.where(lower, torch.exp(torch.where(lower, diff, 0.0)), 0.0) \
        * dtq[:, :, None]                                          # b c i j h
    y = (torch.einsum("bcij,bcijh,bcjhd->bcihd", G, W, xq)
         + torch.exp(cum)[..., None]
         * torch.einsum("bcin,bchdn->bcihd", cq, torch.stack(s_in, 1))
         + D[:, None] * xq)
    return y.reshape(Bb, L, H, dh), s


@pytest.mark.parametrize("B,L,H,dh,N,Q,strong", [
    (1, 256, 2, 32, 16, 128, False),
    (2, 256, 3, 24, 40, 64, False),    # dh, N no multiples of 16
    (1, 128, 1, 16, 8, 128, False),    # single chunk
    (1, 512, 2, 16, 8, 256, True),     # cum passes -88 inside each chunk
])
def test_decomposition_matches_pallas_and_plain(B, L, H, dh, N, Q, strong):
    """The kernel's algebra, carried-in states included, at the reference's
    tolerance.  ``strong``: dt about 0.7 and A = -1 (the models' default
    init), so exp(cum) underflows to 0 inside every chunk while the
    weights near the diagonal do not; B and C are scaled by N**-0.5 there,
    so C·B is of order 1 and each weight's float32 rounding of two
    cumulative sums near -200 (the sides' scans add in other orders) stays
    within the tolerance."""
    ins = list(_inputs(B, L, H, dh, N, seed=L + H + N))
    if strong:
        rng = np.random.default_rng(3)
        ins[1] = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(
            np.float32)
        ins[2] = -np.ones(H, np.float32)
        ins[3], ins[4] = (a / np.float32(np.sqrt(N)) for a in ins[3:5])
    y, s = _decomposed(*_t(ins), Q=Q)
    cum = np.cumsum((ins[1] * ins[2]).reshape(B, L // Q, Q, H), axis=2)
    assert (cum.min() < -88.0) == strong
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y_k, s_k = ssd_chunked_tpu(*_j(ins), Q=Q)
    y_p, s_p = k4.ssd_chunked_plain(*_t(ins), Q=Q)
    for want_y, want_s in ((np.asarray(y_k), np.asarray(s_k)),
                           (y_p.numpy(), s_p.numpy())):
        np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(s.numpy(), want_s, rtol=TOL, atol=TOL)


def test_chunk_invariance():
    """The recurrence result must not depend on the chunk size."""
    ins = _t(_inputs(1, 512, 2, 32, 16, seed=3))
    y1, s1 = k4.ssd_chunked(*ins, Q=128)
    y2, s2 = k4.ssd_chunked(*ins, Q=256)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-4, atol=1e-4)


def test_state_feeds_decode():
    """The final state continues through the port's recurrent decode step
    as a longer scan does, and as the reference's decode step does."""
    x, dt, A, Bm, Cm, D = _inputs(1, 256, 2, 32, 16, seed=5)
    ext = [np.concatenate([a, a[:, :1]], 1) for a in (x, dt, Bm, Cm)]
    y_all, _ = k4.ssd_scan(*_t([ext[0], ext[1], A, ext[2], ext[3], D]),
                           Q=128)
    _, s = k4.ssd_chunked(*_t([x, dt, A, Bm, Cm, D]), Q=128)
    first = [torch.from_numpy(a[:, 0]) for a in (x, dt, Bm, Cm)]
    y_next, s_next = ssm.ssd_decode_step(first[0], first[1],
                                         torch.from_numpy(A), first[2],
                                         first[3], torch.from_numpy(D), s)
    np.testing.assert_allclose(y_next.numpy(), y_all[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    y_ref, s_ref = ref_ssm.ssd_decode_step(
        *_j([x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D]),
        jnp.asarray(s.numpy()))
    np.testing.assert_allclose(y_next.numpy(), np.asarray(y_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s_next.numpy(), np.asarray(s_ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("L", [256, 100])
def test_model_scan_with_init_state(L):
    """A carried-in state (and, at L = 100, a padded last chunk) takes the
    plain scan on both sides."""
    ins = _inputs(2, L, 3, 16, 8, seed=L)
    s0 = np.random.default_rng(9).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    y, s = ssm.ssd_chunked(*_t(ins), chunk=64,
                           init_state=torch.from_numpy(s0))
    y_r, s_r = ref_ssm.ssd_chunked(*_j(ins), chunk=64,
                                   init_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_model_scan_dispatch_matches_reference(impl):
    """Under the kernel's conditions the port's ``ssd_chunked`` takes K4 at
    the reference's Q (256 here, from chunk = 256 at L = 512), against the
    reference's jnp scan and its Pallas kernel."""
    ins = _inputs(2, 512, 4, 8, 16, seed=11)
    prev = ref_ssm.set_ssd_impl(impl)
    try:
        y_r, s_r = ref_ssm.ssd_chunked(*_j(ins))
    finally:
        ref_ssm.set_ssd_impl(prev)
    y, s = ssm.ssd_chunked(*_t(ins))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=TOL, atol=TOL)


def test_segsum_and_validation():
    a = np.random.default_rng(2).uniform(-1, 0, (3, 16)).astype(np.float32)
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(ref_ssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    x, dt, A, Bm, Cm, D = _t(_inputs(1, 256, 2, 8, 4))
    with pytest.raises(ValueError, match="multiple of Q"):
        k4.ssd_chunked(x, dt, A, Bm, Cm, D, Q=100)
    with pytest.raises(ValueError, match="float32"):
        k4.ssd_chunked(x, dt.double(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="unknown SSD"):
        ssm.set_ssd_impl("pallas")
