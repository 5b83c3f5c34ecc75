"""``model_api.loss_fn`` and its gradients on the CPU against
``jax.value_and_grad`` of the JAX package's, on the same weights and
batch: the reduced config of each family (dense minicpm, moe olmoe, vlm
internvl2, audio whisper, ssm mamba2, hybrid zamba2, and gemma2's
softcaps and local windows), B = 2, L = 128 (a vlm's patches included), so
that K3's and K4's wrappers (their plain versions on the CPU) are on the
path; ``remat=True`` on both sides.  The ssm, hybrid and audio families
run in ``test_torch_train_loss_ssm.py``, to keep each file's time short.

Tolerances.  The loss within 1e-5 relative, each parameter's gradient
within 2e-4 in relative L2, both beyond twice the reference's own spread:
the largest change of its loss, and of that parameter's gradient, over
SPREAD_DRAWS draws of one-ulp moves of its weights (``ulp.one_ulp``, as
``tests/test_torch_dense.py`` holds forwards).  The attention families'
gradients move by 2e-4 to 4e-2 of their norm under such moves (Whisper's
most), so no float32 implementation that sums in another order meets a
fixed bound there; the hybrid and SSM ones move by 2e-5 and less.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_models import ref_tree
from ulp import one_ulp

from repro.configs.base import get_config as ref_config
from repro.models import model_api as ref_api
from repro_torch.configs.base import get_config
from repro_torch.convert import named_to_tree, params_from_jax
from repro_torch.models import model_api
from repro_torch.models.params import leaves

ARCHS = ["minicpm-2b", "olmoe-1b-7b", "internvl2-2b", "gemma2-27b"]
SPREAD_DRAWS = 2
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-4


def _batch(cfg, B=2, L=128, seed=3):
    """Tokens and labels (a vlm's text is L minus its patches), and the
    stub inputs, as numpy."""
    rng = np.random.default_rng(seed)
    T = L - cfg.n_patches
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    check_loss_and_gradients(arch)


def check_loss_and_gradients(arch):
    """The port's loss and gradients against the reference's on reduced
    ``arch`` (see the module docstring)."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    tree = ref_tree(rcfg, 0)
    b = _batch(cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: ref_api.loss_fn(p, rcfg, bb, remat=True),
        has_aux=True))
    bb = {k: jnp.asarray(v) for k, v in b.items()}
    runs = []
    for t in [tree] + [one_ulp(tree, s) for s in range(SPREAD_DRAWS)]:
        (loss, aux), g = fn(jax.tree.map(jnp.asarray, t), bb)
        runs.append((float(loss), float(aux["aux"]),
                     dict(leaves(jax.tree.map(np.asarray, g)))))
    (want, want_aux, want_g), near = runs[0], runs[1:]

    model = params_from_jax(cfg, tree, "cpu")
    model.requires_grad_(True)
    loss, metrics = model_api.loss_fn(
        model, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    loss.backward()
    assert set(metrics) == {"loss", "ce", "aux"}
    loss = float(loss.detach())
    assert float(metrics["loss"].detach()) == loss
    spread = max(abs(n[0] - want) for n in near)
    assert abs(loss - want) <= LOSS_RTOL * abs(want) + 2 * spread
    assert float(metrics["aux"].detach()) == pytest.approx(
        want_aux, rel=1e-5, abs=1e-6)
    got_g = dict(leaves(named_to_tree(
        cfg, {k: p.grad for k, p in model.named_parameters()})))
    assert got_g.keys() == want_g.keys()
    for path, w in want_g.items():
        norm = max(float(np.linalg.norm(w)), 1e-30)
        rel = float(np.linalg.norm(got_g[path] - w)) / norm
        sp = max(float(np.linalg.norm(n[2][path] - w)) for n in near) / norm
        assert rel <= GRAD_TOL + 2 * sp, (".".join(path), rel, sp)
        assert np.any(got_g[path] != 0) or not np.any(w != 0), path
