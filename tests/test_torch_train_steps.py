"""Three steps of the port's ``Trainer`` on the CPU against three of the
JAX package's ``make_train_step`` from the same start: the reference's
parameters and optimizer state at step 0, written with the reference's
``checkpoint.save`` and restored by the port's ``Trainer``; the same
batches (one ``TokenStream`` seed, B = 2, L = 128, so that K3's and K4's
wrappers are on the path); AdamW with a WSD schedule.  The loss of every
step and the parameters after the last are compared.

Tolerances.  AdamW's first steps divide each gradient by its own size, so
an element whose gradient is rounding-sized moves by up to lr either way:
after three steps the parameters of a reduced attention model are as far
apart (about a third of the update's norm) under one-ulp moves of the
starting weights as the port is from the reference.  So, as the forwards
of ``tests/test_torch_dense.py``, each step's loss is held within 1e-5
relative and each parameter's distance within 1e-3 of the update's norm,
both beyond twice the reference's own spread over SPREAD_DRAWS one-ulp
draws; Mamba2's spread is some 3e-4 of the update, so there the bound is
tight.  In bfloat16 one-ulp moves of float32 weights vanish in the cast,
and the two packages round their bfloat16 intermediates at other points
(XLA computes fused elementwise chains in float32): each loss is held
within 2**-7 relative (twice bfloat16's unit roundoff), and each
parameter's distance from the reference within twice bfloat16's own
spread of the update's norm: how far the reference's bfloat16 run lands
from its float32 run, over all parameters together (about a quarter of
the update for Mamba2).  That bound stays below the distance of a
parameter left where it started (one update) or moved the wrong way (two).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_models import ref_tree
from ulp import one_ulp

from repro.configs.base import get_config as ref_config
from repro.io import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import TokenStream as RefTokenStream
from repro.train.loop import make_train_step
from repro_torch.configs.base import get_config
from repro_torch.convert import named_to_tree
from repro_torch.models.params import leaves
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig

STEPS, SPREAD_DRAWS = 3, 2
OPT = dict(lr=1e-3, schedule="wsd", warmup_steps=1, total_steps=10)


def _data(cfg):
    return dict(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=0)


@functools.lru_cache(maxsize=None)
def _ref_step(arch):
    return make_train_step(ref_config(arch).reduced(),
                           ref_opt.AdamWConfig(**OPT), remat=True,
                           donate=False)


@functools.lru_cache(maxsize=None)
def _ref_run(arch, dtype, draw=None):
    """The reference's losses and final parameters from ``ref_tree`` (moved
    by one ulp with seed ``draw`` when it is given); kept for the module,
    so that the bfloat16 case reuses the float32 run."""
    rcfg = ref_config(arch).reduced()
    tree = ref_tree(rcfg, 0)
    if draw is not None:
        tree = one_ulp(tree, draw)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    state = ref_opt.init_opt_state(params)
    stream = RefTokenStream(RefDataConfig(**_data(rcfg)))
    losses = []
    for _ in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(stream).items()}
        params, state, m = _ref_step(arch)(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, dict(leaves(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), params)))


@pytest.mark.parametrize("arch,dtype", [("mamba2-130m", "float32"),
                                        ("minicpm-2b", "float32"),
                                        ("mamba2-130m", "bfloat16")])
def test_trainer_steps_match_reference(arch, dtype, tmp_path):
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    tree = ref_tree(rcfg, 0)
    jdt = getattr(jnp, dtype)
    want_loss, want = _ref_run(arch, dtype)
    near = ([] if dtype == "bfloat16" else
            [_ref_run(arch, dtype, s) for s in range(SPREAD_DRAWS)])

    p0 = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    ref_ckpt.save(str(tmp_path), 0, {"params": p0,
                                     "opt": ref_opt.init_opt_state(p0)},
                  extra={"data_state": {"next_index": 0, "seed": 0}})
    tr = Trainer(cfg, TrainConfig(steps=STEPS, ckpt_dir=str(tmp_path),
                                  param_dtype=dtype),
                 AdamWConfig(**OPT), DataConfig(**_data(cfg)), device="cpu")
    assert tr.step == 0
    assert all(p.dtype == getattr(torch, dtype) for p in tr.params.values())
    tr.run()
    got_loss = [m["loss"] for m in tr.metrics_log]
    got = dict(leaves(named_to_tree(
        cfg, {k: p.float() for k, p in tr.params.items()})))
    init = dict(leaves(tree))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got_loss, want_loss, rtol=2.0 ** -7)
        _, exact = _ref_run(arch, "float32")
        init = {k: np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
                for k, a in init.items()}
        upd = {k: float(np.linalg.norm(w - init[k])) for k, w in want.items()}
        spread = float(np.sqrt(sum(np.linalg.norm(exact[k] - w) ** 2
                                   for k, w in want.items()))
                       / np.sqrt(sum(u * u for u in upd.values())))
        assert 2 * spread < 1, spread  # a no-op update must fail the bound
        for path, w in want.items():
            dist = float(np.linalg.norm(got[path] - w))
            assert dist <= 2 * spread * upd[path], (
                ".".join(path), dist, upd[path], spread)
        return
    for i, (g, w) in enumerate(zip(got_loss, want_loss)):
        spread = max(abs(n[0][i] - w) for n in near)
        assert abs(g - w) <= 1e-5 * abs(w) + 2 * spread, (i, g, w, spread)
    for path, w in want.items():
        upd = max(float(np.linalg.norm(w - init[path])), 1e-30)
        rel = float(np.linalg.norm(got[path] - w)) / upd
        sp = max(float(np.linalg.norm(n[1][path] - w)) for n in near) / upd
        assert rel <= 1e-3 + 2 * sp, (".".join(path), rel, sp)
