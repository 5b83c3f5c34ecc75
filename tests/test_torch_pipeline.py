"""The port's GPipe pipeline (``distributed/pipeline.py``): the layer split
and bubble against the reference's, and the reference test's set-up
(S = 4, nm = 8, mb = 2, D = 16, seed 0) on 8 gloo ranks as a (4, 2)
("stage", "data") mesh against the reference's sequential chain and its
``jax.grad``, at the reference test's own tolerances."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.distributed.pipeline import bubble_fraction as ref_bubble
from repro.distributed.pipeline import stage_split as ref_split
from repro_torch.distributed.pipeline import bubble_fraction, stage_split

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

S, NM, MB, D = 4, 8, 2, 16


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4, 5, 8, 16])
def test_stage_split_and_bubble_equal_the_reference(n_stages):
    for n_layers in range(n_stages, 130, 7):
        assert stage_split(n_layers, n_stages) == \
            ref_split(n_layers, n_stages)
    for n_micro in (1, 2, 3, 8, 28, 64):
        assert bubble_fraction(n_micro, n_stages) == \
            ref_bubble(n_micro, n_stages)


def _setup():
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((NM, MB, D)).astype(np.float32)
    return W, x


@pytest.fixture(scope="module")
def ranks():
    W, x = _setup()
    return torch_ranks.launch(8, "job_pipeline", {"W": W, "x": x})


def _ref(W, x):
    z = x
    for s in range(S):
        z = jax.nn.gelu(z @ W[s])
    return z


def test_pipeline_matches_the_sequential_chain(ranks):
    W, x = _setup()
    want = np.asarray(_ref(jnp.asarray(W), jnp.asarray(x)))
    for r in ranks:   # every stage (and data) rank returns the outputs
        np.testing.assert_allclose(r["y"], want, rtol=2e-5, atol=2e-5)


def test_pipeline_gradients_match_jax_grad(ranks):
    W, x = _setup()
    gW, gx = jax.grad(lambda w, xx: _ref(w, xx).sum(), argnums=(0, 1))(
        jnp.asarray(W), jnp.asarray(x))
    for r in ranks:
        np.testing.assert_allclose(r["gW"], np.asarray(gW), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["gx"], np.asarray(gx), rtol=2e-4,
                                   atol=2e-4)
        assert np.all(np.abs(r["gW"]).sum(axis=(1, 2)) > 0)


def test_one_stage_is_the_plain_chain(ranks):
    """At S = 1 the ring permute is the identity (no send to self): the
    outputs and gradients are the stage function's own on the whole batch,
    up to the order of float32 sums (micro-batch by micro-batch)."""
    for r in ranks:
        for got, want in r["s1"]:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
