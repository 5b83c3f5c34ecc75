"""The port's flash attention (K3) on the CPU: its plain version against the
JAX package's Pallas kernel in interpret mode and a float64 oracle, and the
port's ``models/layers.py::flash_attention`` against the reference's in all
three of its dispatch cases, and its ``attention`` block in its three cases.

Float32 tolerance is the reference's own (``tests/test_flash_kernel.py``):
``rtol = atol = 2e-4``; bfloat16 inputs ``3e-2``.  Both sides run the
online softmax in float32 and sum in other orders, so they agree to float32
rounding, far inside that.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_tpu
from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import layers

TOL = 2e-4


def oracle(q, k, v, causal=True, softcap=0.0):
    """Attention in float64 with the whole score matrix."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = np.asarray(q, np.float64).reshape(B, L, KV, G, hd)
    s = np.einsum("blkgd,bskd->blkgs", qf, np.asarray(k, np.float64))
    s = s / math.sqrt(hd)
    if softcap > 0.0:
        s = np.tanh(s / softcap) * softcap
    if causal:
        mask = np.arange(L)[:, None] >= np.arange(S)[None, :]
        s = np.where(mask[None, :, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    out = np.einsum("blkgs,bskd->blkgd", p, np.asarray(v, np.float64))
    return out.reshape(B, L, H, hd)


def _qkv(B, L, H, KV, hd, seed, S=None):
    rng = np.random.default_rng(seed)
    S = L if S is None else S
    return (rng.standard_normal((B, L, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,L,H,KV,hd,Bq,Bk", [
    (1, 256, 4, 4, 64, 128, 128),    # MHA
    (2, 256, 8, 2, 64, 128, 64),     # GQA G=4
    (1, 512, 4, 1, 128, 256, 256),   # MQA, bigger head
    (1, 128, 2, 2, 32, 128, 128),    # single q block
    (2, 256, 4, 4, 112, 128, 128),   # Zamba2-7B's head dimension
    (2, 128, 4, 2, 16, 128, 128),    # reduced Zamba2-7B: G = 2, hd = 16
])
def test_plain_matches_pallas_and_oracle(B, L, H, KV, hd, Bq, Bk):
    q, k, v = _qkv(B, L, H, KV, hd, seed=L + H + hd)
    k3.reset_launches()
    got = k3.flash_attention(*_t(q, k, v), Bq=Bq, Bk=Bk).numpy()
    assert k3.LAUNCHES["flash_attention"] == 0       # plain on the CPU
    want = np.asarray(flash_attention_tpu(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), Bq=Bq, Bk=Bk))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle(q, k, v), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
def test_plain_dtypes(dtype, tol):
    q, k, v = _qkv(1, 256, 4, 4, 64, seed=0)
    qt, kt, vt = (t.to(dtype) for t in _t(q, k, v))
    got = k3.flash_attention(qt, kt, vt)
    assert got.dtype == dtype
    want = oracle(*(t.float().numpy() for t in (qt, kt, vt)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_plain_softcap_noncausal():
    q, k, v = _qkv(1, 256, 2, 2, 64, seed=1)
    got = k3.flash_attention(*_t(q, k, v), causal=False, softcap=30.0)
    want = np.asarray(flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        softcap=30.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle(q, k, v, False, 30.0),
                               rtol=TOL, atol=TOL)


def test_causality_property():
    """Changing future K/V rows must not change past outputs."""
    q, k, v = _qkv(1, 256, 2, 2, 32, seed=2)
    out1 = k3.flash_attention(*_t(q, k, v), Bq=128, Bk=128).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, 200:] = 99.0
    v2[:, 200:] = -99.0
    out2 = k3.flash_attention(*_t(q, k2, v2), Bq=128, Bk=128).numpy()
    np.testing.assert_allclose(out1[:, :200], out2[:, :200], rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(out1[:, 201:], out2[:, 201:])


def test_wrapper_validates():
    q, k, v = _t(*_qkv(1, 256, 4, 2, 32, seed=3))
    with pytest.raises(ValueError, match="multiples"):
        k3.flash_attention(q, k, v, Bq=96)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        k3.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="multiple of KV"):
        k3.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="unknown attention"):
        layers.set_flash_impl("pallas")


def _both(impl, q, k, v, **kw):
    """The reference's layers.flash_attention under ``impl`` and the
    port's, same inputs."""
    prev = ref_layers.set_flash_impl(impl)
    try:
        want = np.asarray(ref_layers.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            q_positions=jnp.asarray(kw["q_positions"]),
            **{a: b for a, b in kw.items() if a != "q_positions"}))
    finally:
        ref_layers.set_flash_impl(prev)
    got = layers.flash_attention(
        *_t(q, k, v), q_positions=torch.from_numpy(kw["q_positions"]),
        **{a: b for a, b in kw.items() if a != "q_positions"}).numpy()
    return got, want


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_layer_dispatch_matches_reference(impl):
    """The three dispatch cases, against the reference's jnp and Pallas
    settings: the kernel's conditions (L = S = 128, full cache), one query
    against a partly filled cache, and a length that is no multiple of
    128 (the plain chunk scan, several key chunks)."""
    q, k, v = _qkv(2, 128, 4, 2, 16, seed=4)
    k3.reset_launches()
    got, want = _both(impl, q, k, v, q_positions=np.arange(128), s_valid=128,
                      kv_chunk=64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    q1, kc, vc = _qkv(2, 1, 4, 2, 16, seed=5, S=16)
    got, want = _both(impl, q1, kc, vc, q_positions=np.array([4]), s_valid=5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    q, k, v = _qkv(2, 100, 4, 2, 16, seed=6)
    got, want = _both(impl, q, k, v, q_positions=np.arange(100), s_valid=100,
                      kv_chunk=32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert k3.LAUNCHES["flash_attention"] == 0


def test_layer_plain_toggle():
    """``set_flash_impl("plain")`` takes K3's plain version under the
    kernel's conditions; on the CPU the wrapper runs the same code."""
    q, k, v = _t(*_qkv(1, 256, 4, 4, 32, seed=7))
    kw = dict(q_positions=torch.arange(256), s_valid=256)
    a = layers.flash_attention(q, k, v, **kw)
    prev = layers.set_flash_impl("plain")
    try:
        b = layers.flash_attention(q, k, v, **kw)
    finally:
        layers.set_flash_impl(prev)
    assert torch.equal(a, b)


def test_attention_block_matches_reference():
    """``layers.attention`` (projections, RoPE, the cache, the output
    projection) against the reference's in its three cases: no cache, a
    self-attention decode step writing its cache in place, and
    cross-attention over an already projected (cached) memory."""
    rng = np.random.default_rng(8)
    D, H, KV, hd = 32, 4, 2, 16
    p = {"wq": rng.standard_normal((D, H, hd)) / 4,
         "wk": rng.standard_normal((D, KV, hd)) / 4,
         "wv": rng.standard_normal((D, KV, hd)) / 4,
         "wo": rng.standard_normal((H, hd, D)) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    kw = dict(n_heads=H, n_kv=KV, hd=hd, rope_theta=10000.0)
    x = rng.standard_normal((2, 128, D)).astype(np.float32)
    want, _ = ref_layers.attention(pj, jnp.asarray(x),
                                   positions=jnp.arange(128), **kw)
    got, _ = layers.attention(pt, torch.from_numpy(x),
                              positions=torch.arange(128), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    cache = rng.standard_normal((2, 16, KV, hd)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, D)).astype(np.float32)
    want, wc = ref_layers.attention(
        pj, jnp.asarray(x1), positions=jnp.arange(5, 6),
        cache={"k": jnp.asarray(cache), "v": jnp.asarray(cache)},
        cache_pos=5, **kw)
    tc = {"k": torch.from_numpy(cache.copy()),
          "v": torch.from_numpy(cache.copy())}
    got, gc = layers.attention(pt, torch.from_numpy(x1),
                               positions=torch.arange(5, 6), cache=tc,
                               cache_pos=5, **kw)
    assert gc is tc
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                   rtol=TOL, atol=TOL)
    want, _ = ref_layers.attention(
        pj, jnp.asarray(x1), positions=jnp.arange(5, 6),
        cache={"k": jnp.asarray(cache), "v": jnp.asarray(cache)},
        cross_cached=True, **kw)
    got, _ = layers.attention(
        pt, torch.from_numpy(x1), positions=torch.arange(5, 6),
        cache={"k": torch.from_numpy(cache), "v": torch.from_numpy(cache)},
        cross_cached=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _tf32(x):
    """x (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10
    mantissa bits kept, to nearest with ties away from zero (adding half a
    unit to the magnitude bits, then clearing the 13 low bits)."""
    bits = x.view(torch.int32).to(torch.int64)
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return torch.where(bits >= 1 << 31, bits - (1 << 32),
                       bits).to(torch.int32).view(torch.float32)


def _split_mm(a, b, terms):
    """a @ b (float32) as the kernel forms it on the tensor cores: a and b
    split as hi = tf32(x), lo = tf32(x - hi), each TF32 product exact in
    float32 and summed in float32.  ``terms`` 3: a_hi b_hi + a_hi b_lo +
    a_lo b_hi (the kernel's split); 1: a_hi b_hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if terms == 3:
        out = out + ah @ _tf32(b - bh) + _tf32(a - ah) @ bh
    return out


def _attention_split(q, k, v, terms):
    """Causal attention of one head (q, k, v (L, hd) float32) with both
    products through ``_split_mm`` and the softmax in float32, as the
    kernel computes it (one key tile: the online rescaling is exact)."""
    s = _split_mm(q * (1.0 / math.sqrt(q.shape[1])), k.T, terms)
    s = torch.where(torch.ones_like(s, dtype=torch.bool).tril(), s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _split_mm(p, v, terms) / p.sum(-1, keepdim=True)


def _attention_scale(q, k, v):
    """Float64 attention output of one causal head and its first-order
    error scale per element, ``E = sum_j p_j (S_j |v_j - o| + |v_j|)``,
    ``S_j = scale * sum_d |q_d| |k_jd|``: the scale chip_smoke.py's
    ``attention_scale`` holds each K3 call to (FLOAT_TOL * E)."""
    q, k, v = q.double(), k.double(), v.double()
    qs = q / math.sqrt(q.shape[1])
    s = torch.where(torch.ones((q.shape[0], k.shape[0]),
                               dtype=torch.bool).tril(), qs @ k.T, -math.inf)
    p = torch.softmax(s, -1)
    o = p @ v
    w = p * (qs.abs() @ k.abs().T)
    e = p @ v.abs() + (w[..., None] * (v[None] - o[:, None]).abs()).sum(1)
    return o, e


@pytest.mark.parametrize("spread", [1.0, 10.0])
def test_three_term_tf32_split_holds_float32_accuracy(spread):
    """The kernel's arithmetic, emulated: at hd = 112 (Zamba2-7B), both
    products through the three-term TF32 split stay within 1e-5 of the
    error scale of float64 attention, as every K3 call of a prefill must
    on the card; one TF32 term does not (so the bound tells them apart).
    ``spread`` scales q: 10 gives scores spread over tens, as the
    random-weight model's are."""
    rng = np.random.default_rng(16)
    L, hd = 256, 112
    for h in range(2):
        q, k, v = (torch.from_numpy(rng.standard_normal((L, hd))
                                    .astype(np.float32)) for _ in range(3))
        q = q * spread
        want, scale = _attention_scale(q, k, v)
        three = (_attention_split(q, k, v, 3).double() - want).abs()
        one = (_attention_split(q, k, v, 1).double() - want).abs()
        assert float((three / scale).max()) <= 1e-5
        assert float((one / scale).max()) > 1e-5
