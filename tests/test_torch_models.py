"""The port's models on the CPU against the JAX package's, on the same
weights: reduced Zamba2-7B (13 layers: 2 super-blocks of the shared
attention block and 6 Mamba-2 layers, then a tail of 1; 4 query heads over
2 KV heads) and reduced Mamba2-130M.  The weights follow the reference's
parameter definitions (shapes, init kinds, scales), drawn with numpy from a
seed, and reach the port through ``convert.params_from_jax``.

Tolerances.  Forward logits: ``rtol = atol = 2e-4``.  Both sides compute in
float32 and sum in other orders; through the reduced Zamba2's 13 layers the
residual stream grows to ~36 in magnitude (its relative difference after
the last layer is ~1.7e-5, float32 rounding of those sums), and on these
inputs the logits (magnitude up to ~5) differ by up to 1.05e-4, which is
|diff| / (1 + |logit|) = 9.9e-5 against the reference's jnp path: 0.99 of
the 1e-4 this file started from, with no room for another summation order
(a thread count), so the bound is 2e-4.  Mamba2-130M measured 3.8e-5.
Decode logits and caches: ``1e-4`` (measured below 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.models import layers as ref_layers
from repro.models import model_api as ref_api
from repro.models import ssm as ref_ssm
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.models import model_api

TOL = 1e-4           # decode steps
LOGIT_TOL = 2e-4     # full forwards (see the module docstring)
ARCHS = ["zamba2-7b", "mamba2-130m"]


def ref_tree(rcfg, seed: int) -> dict:
    """The reference's parameter tree (its ``pdefs``: shapes, init kinds,
    scales) filled from a numpy generator, as numpy arrays: the weights
    both models get."""
    from repro.models.params import PDef
    rng = np.random.default_rng(seed)

    def fill(node):
        if not isinstance(node, PDef):
            return {k: fill(node[k]) for k in sorted(node)}
        if node.init in ("zeros", "ones"):
            return np.full(node.shape, node.init == "ones", np.float32)
        fan_in = node.shape[-2] if len(node.shape) >= 2 else node.shape[-1]
        scale = node.scale if node.scale is not None else fan_in ** -0.5
        return (rng.standard_normal(node.shape) * scale).astype(np.float32)
    return fill(ref_api.pdefs(rcfg))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference params, port cfg, port model), on the
    same weights."""
    rcfg = ref_config(request.param).reduced()
    tree = ref_tree(rcfg, seed=0)
    cfg = get_config(request.param).reduced()
    model = params_from_jax(cfg, tree, "cpu")
    return rcfg, jax.tree.map(jnp.asarray, tree), cfg, model


def _tokens(cfg, B, L, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, L))


def _ref_forward(rcfg, params, toks, impl, **kw):
    prev = (ref_layers.set_flash_impl(impl), ref_ssm.set_ssd_impl(impl))
    try:
        out, _ = ref_api.forward(params, rcfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 remat=False, **kw)
    finally:
        ref_layers.set_flash_impl(prev[0])
        ref_ssm.set_ssd_impl(prev[1])
    return np.asarray(out)


def test_configs_are_the_references():
    for arch in ARCH_IDS:
        assert get_config(arch).__dict__ == ref_config(arch).__dict__, arch
        assert get_config(arch).reduced().__dict__ \
            == ref_config(arch).reduced().__dict__, arch
    assert {k: v.__dict__ for k, v in SHAPES.items()} == {
        k: v.__dict__ for k, v in __import__(
            "repro.configs.base", fromlist=["SHAPES"]).SHAPES.items()}


# Full-size parameter counts the card runs hold (chip_smoke.py).
N_PARAMS = {"zamba2-7b": 6_749_959_248, "mamba2-130m": 167_752_128,
            "yi-9b": 8_829_407_232, "olmoe-1b-7b": 6_919_620_608,
            "internvl2-2b": 1_893_828_608, "whisper-medium": 811_198_464}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_and_shapes_equal_the_references(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert model_api.n_params(cfg) == ref_api.n_params(rcfg)
    if arch in N_PARAMS:
        assert model_api.n_params(cfg) == N_PARAMS[arch]
    for B, S in ((2, 16), (3, 40)):
        want = ref_api.cache_shapes(rcfg, B, S, dtype=jnp.float32)
        got = model_api.cache_shapes(cfg, B, S, dtype=torch.float32)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def test_forward_matches_reference(pair):
    """L = 128 (B = 2): the kernel conditions hold, so the port runs K3's
    and K4's wrappers (their plain versions on the CPU); the reference runs
    its Pallas kernels in interpret mode, then its jnp paths."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, 2, 128, seed=1)
    k3.reset_launches()
    k4.reset_launches()
    got, aux = model_api.forward(model, cfg,
                                 {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 128, cfg.vocab_padded) and float(aux) == 0.0
    assert k3.LAUNCHES["flash_attention"] == k4.LAUNCHES["ssd_chunked"] == 0
    for impl in ("pallas", "jnp"):
        np.testing.assert_allclose(got.numpy(),
                                   _ref_forward(rcfg, params, toks, impl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=impl)


def test_last_only_and_unaligned_length(pair):
    """``logits_last_only`` is the last row of the full logits; L = 100
    takes the plain paths on both sides."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, 2, 100, seed=2)
    full, _ = model_api.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    last, _ = model_api.forward(model, cfg, {"tokens": torch.from_numpy(toks)},
                                logits_last_only=True)
    assert last.shape == (2, 1, cfg.vocab_padded)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-6, atol=1e-6)
    assert torch.equal(model(torch.from_numpy(toks), last_only=True)[0],
                       last)                  # the nn.Module interface
    want = _ref_forward(rcfg, params, toks, "jnp")
    np.testing.assert_allclose(full.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_decode_matches_reference(pair):
    """Eight teacher-forced decode steps, logits and caches, against the
    reference's (jitted, as its server runs it); the port's caches are
    updated in place and returned."""
    rcfg, params, cfg, model = pair
    toks = _tokens(cfg, 2, 8, seed=3)
    ref_step = jax.jit(lambda p, c, t, pos: ref_api.decode_step(p, rcfg, c,
                                                                t, pos))
    rc = ref_api.init_cache(rcfg, 2, 16, dtype=jnp.float32)
    pc = model_api.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(8):
        lr, rc = ref_step(params, rc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        lp, pc2 = model_api.decode_step(model, cfg, pc,
                                        torch.from_numpy(toks[:, t:t + 1]), t)
        assert pc2 is pc
        np.testing.assert_allclose(lp.numpy(), np.asarray(lr), rtol=TOL,
                                   atol=TOL)
    for k in rc:
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("L", [384, 640])
def test_forward_at_lengths_of_odd_128_blocks(L):
    """L = 384 and 640 meet the kernel's conditions but are no multiple of
    256: the port's block sizes divide them (gcd(L, 256)) and its forward
    equals the reference's jnp path (its Pallas toggle asserts there)."""
    arch = "zamba2-7b"
    rcfg = ref_config(arch).reduced()
    tree = ref_tree(rcfg, seed=0)
    cfg = get_config(arch).reduced()
    model = params_from_jax(cfg, tree, "cpu")
    toks = _tokens(cfg, 1, L, seed=4)
    got, _ = model_api.forward(model, cfg, {"tokens": torch.from_numpy(toks)})
    want = _ref_forward(rcfg, jax.tree.map(jnp.asarray, tree), toks, "jnp")
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def _first_leaf(tree, path=()):
    k = sorted(tree)[0]
    node = tree[k]
    return _first_leaf(node, path + (k,)) if isinstance(node, dict) \
        else path + (k,)


def _without(tree, path):
    """A copy of ``tree`` (dicts copied along ``path``) without ``path``."""
    if len(path) == 1:
        return {k: v for k, v in tree.items() if k != path[0]}
    return dict(tree, **{path[0]: _without(tree[path[0]], path[1:])})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_and_carry_over_checks(arch):
    """``init_params`` makes the reference's tree from a seed, the same
    values from the same seed; ``params_from_jax`` refuses a tree with a
    key missing, a key too many or a shape that differs."""
    cfg = get_config(arch).reduced()
    a = model_api.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = model_api.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sum(p.numel() for p in pa.values()) == model_api.n_params(cfg)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    if arch == "zamba2-7b":
        assert float(pa["shared_attn.ln1"].abs().max()) == 0.0
        assert float(pa["mamba_super.0.0.D"].min()) == 1.0
    tree = ref_tree(ref_config(arch).reduced(), seed=1)
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(cfg, _without(tree, _first_leaf(tree)), "cpu")
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(cfg, dict(tree, bogus=np.zeros(3)), "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(cfg, dict(tree, final_norm=np.zeros(3)), "cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch(arch):
    """The same seed gives the reference's batch: the same keys in the same
    order and equal values, at the cells' full shapes."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    for cell in ("train_4k", "decode_32k"):
        got = model_api.make_batch(cfg, SHAPES[cell],
                                   np.random.default_rng(0), device="cpu")
        want = ref_api.make_batch(rcfg, REF_SHAPES[cell],
                                  np.random.default_rng(0))
        assert list(got) == list(want), cell
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (cell, k)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{cell} {k}")
    batch = model_api.make_batch(cfg, SHAPES["train_4k"],
                                 np.random.default_rng(0), device="cpu")
    assert batch["tokens"].shape == batch["labels"].shape == (256, 4096)
    assert int(batch["tokens"].max()) < cfg.vocab
    dec = model_api.make_batch(cfg, SHAPES["decode_32k"],
                               np.random.default_rng(0), device="cpu")
    assert dec["tokens"].shape == (128, 1) and int(dec["pos"]) == 0
