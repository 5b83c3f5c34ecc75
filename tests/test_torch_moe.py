"""The port's MoE block and MoE models on the CPU against the JAX
package's: reduced OLMoE-1B-7B (4 experts, top-2) and Llama4-Scout (4
experts, top-1, a shared expert), on the reference's parameter definitions
drawn with numpy (``test_torch_models.ref_tree``).

The block is held with its expert choices, tie order and drops equal to the
reference's: ``moe_block``'s output at 1e-5 (one layer's float32 products,
summed in other orders) and its aux loss at 1e-6; the whole models as the
dense models are (``test_torch_dense.py``: 2e-4 forward and 1e-4 decode,
beyond twice the reference's own one-ulp spread).  Decode is held against
the reference's decode step, not against the prefill: at decode each step's
capacity is ``ceil(B * K / E * 1.25)`` slots an expert, so its drops differ
from a prefill's by design.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_dense import (check_decode, check_forward, check_last_only,
                              check_layers,
                              k3_calls)  # noqa: F401 (a fixture)
from test_torch_models import ref_tree
from ulp import one_ulp

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_config
from repro.models import model_api as ref_api
from repro.models import moe as ref_moe
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model_api
from repro_torch.models import moe

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
BLOCK_TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    rcfg = ref_config(request.param).reduced()
    tree = ref_tree(rcfg, seed=0)
    cfg = get_config(request.param).reduced()
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(cfg, tree, "cpu"),
            [jax.tree.map(jnp.asarray, one_ulp(tree, seed))
             for seed in range(4)])


def block_inputs(arch, seed, B=2, L=64):
    """Layer 0's MoE weights of the reduced config and x (B, L, D)."""
    cfg = ref_config(arch).reduced()
    p = {k: v[0] for k, v in ref_tree(cfg, seed)["layers"]["moe"].items()}
    x = np.random.default_rng(seed).standard_normal(
        (B, L, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def run_both(cfg, p, x):
    """(port out, port aux, reference out, reference aux) as numpy."""
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k)
    got, aux = moe.moe_block({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), **kw)
    want, raux = ref_moe.moe_block({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), **kw)
    return got.numpy(), float(aux), np.asarray(want), float(raux)


def routes(cfg, p, x):
    """The experts each token picks in the port and in the reference."""
    xt = x.reshape(-1, x.shape[-1])
    _, got = moe.stable_top_k(torch.softmax(
        torch.from_numpy(xt) @ torch.from_numpy(p["router"]), -1), cfg.top_k)
    _, want = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(xt) @ jnp.asarray(p["router"]), -1), cfg.top_k)
    return got.numpy(), np.asarray(want)


def test_stable_top_k_is_lax_top_k():
    """Values and indices, ties (the lower index first) included."""
    rng = np.random.default_rng(0)
    probs = np.round(rng.random((64, 16)), 1).astype(np.float32)  # ties
    for k in (1, 2, 8, 16):
        vals, idx = moe.stable_top_k(torch.from_numpy(probs), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch):
    cfg, p, x = block_inputs(arch, seed=1)
    got_r, want_r = routes(cfg, p, x)
    np.testing.assert_array_equal(got_r, want_r)
    got, aux, want, raux = run_both(cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    assert aux == pytest.approx(raux, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_first_experts(arch):
    """A router of zeros: every probability ties at 1/E, and every token
    picks experts 0 .. K-1, as the reference does."""
    cfg, p, x = block_inputs(arch, seed=2)
    p = dict(p, router=np.zeros_like(p["router"]))
    got_r, want_r = routes(cfg, p, x)
    T = x.shape[0] * x.shape[1]
    np.testing.assert_array_equal(want_r,
                                  np.tile(np.arange(cfg.top_k), (T, 1)))
    np.testing.assert_array_equal(got_r, want_r)
    got, aux, want, raux = run_both(cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    assert aux == pytest.approx(raux, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_to_one_expert_drops_as_the_reference(arch):
    """Positive x and a router whose column 0 alone is large: every token's
    first choice is expert 0 (its second, for top-2, expert 1, the lowest
    of the tied rest), so each takes C of the T pairs it is sent and drops
    the rest in token order: tokens from C on get nothing, in both
    packages."""
    cfg, p, x = block_inputs(arch, seed=3)
    x = np.abs(x)
    router = np.zeros_like(p["router"])
    router[:, 0] = 10.0
    p = dict(p, router=router)
    T = x.shape[0] * x.shape[1]
    C = math.ceil(T * cfg.top_k / cfg.n_experts * 1.25)
    assert C < T
    got_r, want_r = routes(cfg, p, x)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(want_r[:, 0], 0)
    got, aux, want, raux = run_both(cfg, p, x)
    np.testing.assert_allclose(got, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)
    flat, ref_flat = got.reshape(T, -1), want.reshape(T, -1)
    assert not np.any(flat[C:]) and not np.any(ref_flat[C:])
    assert np.all(np.abs(flat[:C]).sum(-1) > 0)
    assert aux == pytest.approx(raux, rel=1e-6, abs=1e-6)


def test_forward_matches_reference(pair, k3_calls):
    """L = 128: every layer calls K3's wrapper; the mean aux loss as the
    reference's."""
    aux, ref_aux = check_forward(pair, k3_calls, 128)
    assert aux == pytest.approx(ref_aux, rel=1e-5)


def test_last_only_and_module_interface(pair):
    check_last_only(pair)


def test_decode_matches_reference(pair):
    check_decode(pair, 8)


def test_layers_match_reference(pair):
    """Teacher-forced layers (attention and the MoE block) at the forward
    (2e-4) and decode (1e-4) tolerances."""
    check_layers(pair, 128, 8)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_active_params_equal_the_references(arch):
    for cfg, rcfg in ((get_config(arch), ref_config(arch)),
                      (get_config(arch).reduced(),
                       ref_config(arch).reduced())):
        assert model_api.n_active_params(cfg) == ref_api.n_active_params(rcfg)
