"""The port's all-to-all MoE (``distributed/moe_a2a.py``) on 4 gloo ranks
(a (4,) model mesh, then (2, 2) data x model) against the reference's
one-device ``models/moe.py::moe_block`` and the port's ``moe_block``: a
reduced OLMoE layer (8 experts, top-2, d 64) whose weights come through
``convert.params_from_jax``, with capacity enough that nothing drops."""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_config
from repro.models import model_api as ref_api
from repro.models.moe import moe_block as ref_moe_block
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.moe import moe_block

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

E, K, CF = 8, 2, 8.0
B, L = 4, 16


def _layer():
    """Layer 0's MoE weights of the reduced OLMoE (8 experts), made by the
    reference and carried into the port's model."""
    rcfg = dataclasses.replace(ref_config("olmoe-1b-7b").reduced(),
                               n_experts=E, top_k=K)
    pcfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                               n_experts=E, top_k=K)
    tree = jax.tree.map(np.asarray,
                        ref_api.init_params(rcfg, jax.random.key(0)))
    model = params_from_jax(pcfg, tree, device="cpu")
    moe = model.layers[0].moe
    p = {k: getattr(moe, k).detach().numpy().copy()
         for k in ("router", "w_gate", "w_in", "w_out")}
    for k, v in p.items():   # the same values as the reference's tree
        np.testing.assert_array_equal(v, tree["layers"]["moe"][k][0])
    return p, pcfg.d_model


@pytest.fixture(scope="module")
def case():
    p, D = _layer()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    cot = rng.standard_normal((B, L, D)).astype(np.float32)
    res = torch_ranks.launch(4, "job_moe", dict(p, x=x, cot=cot, E=E, K=K,
                                                cf=CF))
    return p, x, cot, res


_ref_jit = jax.jit(lambda p, x: ref_moe_block(p, x, n_experts=E, top_k=K,
                                              capacity_factor=CF))


def _ref(p, x):
    out, aux = _ref_jit({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("mesh", ["m4", "d2m2"])
def test_output_and_aux_match_the_reference(case, mesh):
    p, x, _, res = case
    want, aux = _ref(p, x)
    if mesh == "d2m2":
        # the aux loss is a mean over the model group, then over data rows
        # (the reference's moe_block_a2a): each row's own dense aux, mean
        aux = np.mean([_ref(p, x[i * B // 2:(i + 1) * B // 2])[1]
                       for i in range(2)])
    for r in res:
        got = r[mesh]
        assert got["y"].shape == (B, L, x.shape[-1])
        np.testing.assert_allclose(got["y"], want, rtol=1e-5, atol=1e-5)
        assert abs(got["aux"] - aux) <= 1e-6, (got["aux"], aux)


@pytest.mark.parametrize("mesh", ["m4", "d2m2"])
def test_gradients_match_the_ports_moe_block(case, mesh):
    """The gradients of sum(out * cot), summed over the ranks (each rank's
    block of the output), against the port's one-device moe_block."""
    p, x, cot, res = case
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = moe_block(pt, xt, n_experts=E, top_k=K, capacity_factor=CF)
    (out * torch.from_numpy(cot)).sum().backward()
    want = {k: v.grad.numpy() for k, v in pt.items()}
    want["x"] = xt.grad.numpy()
    for r in res:
        for k, g in r[mesh]["grads"].items():
            scale = max(np.abs(want[k]).max(), 1.0)
            np.testing.assert_allclose(g, want[k], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
            assert np.abs(g).sum() > 0, k
