"""The port's checkpoints against the JAX package's format: a checkpoint
written by either package restores in the other with the same npz keys and
the same arrays; the two-phase commit's partial ``.tmp`` directories are
ignored, ``prune`` keeps the newest, a manifest with a mesh shape restores,
and a restarted ``Trainer`` resumes its step, parameters and stream
position (the reference's ``test_distributed.py`` and
``test_archs.py::test_checkpoint_restart_resumes`` cases); and
``convert.params_to_jax`` inverts ``params_from_jax``."""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_models import ref_tree

from repro.configs.base import get_config as ref_config
from repro.io import checkpoint as ref_ckpt
from repro.models import model_api as ref_api
from repro.train import optimizer as ref_opt
from repro_torch.configs.base import get_config
from repro_torch.convert import (load_tree, named_to_tree, params_from_jax,
                                 params_to_jax)
from repro_torch.io import checkpoint as ckpt
from repro_torch.models import model_api
from repro_torch.models.params import leaves
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig, opt_state_shapes


def _trainer(cfg, ckpt_dir, seed=1, steps=2):
    return Trainer(cfg, TrainConfig(steps=steps, ckpt_every=2,
                                    ckpt_dir=ckpt_dir, seed=seed),
                   AdamWConfig(lr=1e-3, total_steps=20),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                              seed=seed), device="cpu")


def _npz_keys(path):
    (shard,) = [f for f in os.listdir(path) if f.endswith(".npz")]
    with np.load(os.path.join(path, shard)) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch", ["zamba2-7b", "olmoe-1b-7b"])
def test_port_checkpoint_restores_in_the_reference(arch, tmp_path):
    """The port's trainer state after two steps, written by the port,
    restores through the reference's ``restore`` into its own abstract
    state; a reference save of those arrays has the same keys and bytes."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    tr = _trainer(cfg, str(tmp_path / "port"))
    tr.run(2)
    path = ckpt.latest_complete(str(tmp_path / "port"))
    shapes = ref_api.param_shapes(rcfg)
    state, manifest = ref_ckpt.restore(
        path, {"params": shapes, "opt": ref_opt.opt_state_shapes(shapes)})
    assert manifest["step"] == 2
    assert manifest["extra"]["data_state"] == {"next_index": 2, "seed": 1}
    assert int(state["opt"].step) == 2
    for name, want in (("params", tr.params), ("mu", tr.opt_state.mu),
                       ("nu", tr.opt_state.nu)):
        got = state["params"] if name == "params" else getattr(state["opt"],
                                                               name)
        for (path_, a), (_, b) in zip(leaves(named_to_tree(cfg, want)),
                                      leaves(got)):
            np.testing.assert_array_equal(a, b, err_msg=str(path_))
    ref_ckpt.save(str(tmp_path / "ref"), 2, state,
                  extra=manifest["extra"])
    ours = _npz_keys(path)
    theirs = _npz_keys(ref_ckpt.latest_complete(str(tmp_path / "ref")))
    assert sorted(ours) == sorted(theirs) == manifest["keys"]
    assert "params/['embed']" in ours and "opt/.step" in ours
    assert any(k.startswith("opt/.mu['") for k in ours)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-medium"])
def test_reference_checkpoint_restores_in_the_port(arch, tmp_path):
    """The reference's parameters and a one-step optimizer state, written
    by the reference, restore in a port ``Trainer`` (parameters, moments,
    step, stream position), and the port's ``restore`` gives the
    reference's arrays."""
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    params = jax.tree.map(jnp.asarray, ref_tree(rcfg, 0))
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, jnp.float32),
                         params)
    params, state, _ = jax.jit(functools.partial(
        ref_opt.adamw_update, ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1)))(
            params, grads, ref_opt.init_opt_state(params))
    ref_ckpt.save(str(tmp_path), 7, {"params": params, "opt": state},
                  extra={"data_state": {"next_index": 7, "seed": 1}})
    shapes = model_api.param_shapes(cfg)
    got, manifest = ckpt.restore(ckpt.latest_complete(str(tmp_path)),
                                 {"params": shapes,
                                  "opt": opt_state_shapes(shapes)})
    assert manifest["step"] == 7 and int(got["opt"].step) == 1
    want = {"params": params, "mu": state.mu, "nu": state.nu}
    tr = _trainer(cfg, str(tmp_path))
    assert tr.step == 7 and tr.data.next_index == 7
    assert int(tr.opt_state.step) == 1
    for name, ours in (("params", tr.params), ("mu", tr.opt_state.mu),
                       ("nu", tr.opt_state.nu)):
        restored = got["params"] if name == "params" else getattr(
            got["opt"], name)
        for (p, a), (_, b), (_, c) in zip(
                leaves(jax.tree.map(np.asarray, want[name])),
                leaves(restored), leaves(named_to_tree(cfg, ours))):
            np.testing.assert_array_equal(b, a, err_msg=str(p))
            np.testing.assert_array_equal(c, a, err_msg=str(p))


def test_bfloat16_leaves_are_the_references_bytes(tmp_path):
    """A bfloat16 tensor is written as the reference writes a bfloat16
    array (2-byte words, dtype V2), and reads back as bfloat16."""
    w = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    ref_ckpt.save(str(tmp_path / "ref"), 1,
                  {"params": {"w": jnp.asarray(w, jnp.bfloat16)}})
    ckpt.save(str(tmp_path / "port"), 1,
              {"params": {"w": torch.from_numpy(w).bfloat16()}})
    a = _npz_keys(ckpt.latest_complete(str(tmp_path / "ref")))
    b = _npz_keys(ckpt.latest_complete(str(tmp_path / "port")))
    assert a.keys() == b.keys() == {"params/['w']"}
    assert a["params/['w']"].dtype == b["params/['w']"].dtype
    assert a["params/['w']"].tobytes() == b["params/['w']"].tobytes()
    t = {"w": torch.zeros((3, 5), dtype=torch.bfloat16)}
    state, _ = ckpt.restore(ckpt.latest_complete(str(tmp_path / "ref")),
                            {"params": {"w": t["w"]}})
    from repro_torch.convert import from_numpy
    assert torch.equal(from_numpy(state["params"]["w"]),
                       torch.from_numpy(w).bfloat16())


# -- the reference's test_distributed.py checkpoint cases -------------------
def test_partial_checkpoint_ignored(tmp_path):
    """A crash between payload and manifest leaves no restorable state."""
    d = str(tmp_path)
    state = {"params": {"w": np.arange(6.0).reshape(2, 3)}}
    ckpt.save(d, 5, state)
    part = os.path.join(d, "step_00000010.tmp")
    os.makedirs(part)
    np.savez(os.path.join(part, "shard_00000.npz"),
             **{"params/['w']": np.zeros((2, 3))})
    latest = ckpt.latest_complete(d)
    assert latest and latest.endswith("step_00000005")
    restored, manifest = ckpt.restore(latest, state)
    np.testing.assert_array_equal(restored["params"]["w"],
                                  state["params"]["w"])
    assert manifest["step"] == 5
    assert ref_ckpt.latest_complete(d) == latest


def test_prune_keeps_newest_and_cleans_tmp(tmp_path):
    d = str(tmp_path)
    state = {"p": {"w": np.zeros(3)}}
    for step in (1, 2, 3, 4):
        ckpt.save(d, step, state)
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    ckpt.prune(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]


def test_resharding_restore_shapes(tmp_path):
    d = str(tmp_path)
    state = {"params": {"w": np.random.default_rng(0)
                        .standard_normal((16, 8))}}
    ckpt.save(d, 1, state, mesh_shape=(2, 16, 16))
    restored, manifest = ckpt.restore(ckpt.latest_complete(d), state)
    assert manifest["mesh_shape"] == [2, 16, 16]
    np.testing.assert_array_equal(restored["params"]["w"],
                                  state["params"]["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(ckpt.latest_complete(d),
                     {"params": {"w": np.zeros((8, 16))}})
    with pytest.raises(KeyError, match="no \\['v'\\]"):
        ckpt.restore(ckpt.latest_complete(d),
                     {"params": {"v": np.zeros((16, 8))}})


def test_checkpoint_restart_resumes(tmp_path):
    """Kill-and-restart: a fresh Trainer restores step, params, moments and
    data stream position from the sealed checkpoint, and its next steps
    equal those of the trainer that kept running."""
    cfg = get_config("mamba2-130m").reduced()
    ck = str(tmp_path / "ckpt")
    t1 = _trainer(cfg, ck, steps=10)
    t1.run(10)
    assert t1.step == 10
    t2 = _trainer(cfg, ck, steps=10)
    assert t2.step == 10 and t2.data.next_index == t1.data.next_index
    for k, p in t1.params.items():
        assert torch.equal(p, t2.params[k]), k
        assert torch.equal(t1.opt_state.mu[k], t2.opt_state.mu[k]), k
    t2.run(2)
    t1.run(2)
    assert t2.step == t1.step == 12
    assert t2.metrics_log[-1]["loss"] == t1.metrics_log[-1]["loss"]
    for k, p in t1.params.items():
        assert torch.equal(p, t2.params[k]), k


# -- params_to_jax ----------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2-7b", "olmoe-1b-7b",
                                  "whisper-medium", "internvl2-2b"])
def test_params_to_jax_inverts_params_from_jax(arch):
    cfg = get_config(arch).reduced()
    tree = ref_tree(ref_config(arch).reduced(), 0)
    back = params_to_jax(cfg, params_from_jax(cfg, tree, "cpu"))
    want, got = dict(leaves(tree)), dict(leaves(back))
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_tree_conversions_raise_on_a_wrong_tree():
    cfg = get_config("mamba2-130m").reduced()
    model = model_api.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    named = dict(model.named_parameters())
    with pytest.raises(KeyError, match="missing"):
        named_to_tree(cfg, {k: v for k, v in named.items() if k != "embed"})
    with pytest.raises(KeyError, match="extra"):
        named_to_tree(cfg, dict(named, bogus=named["embed"]))
    with pytest.raises(KeyError, match="full stack"):
        named_to_tree(cfg, {k: v for k, v in named.items()
                            if not k.startswith("layers.1.")})
    tree = params_to_jax(cfg, model)
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="shape"):
        load_tree(named, bad)
    with pytest.raises(KeyError, match="without a tensor"):
        load_tree(named, dict(tree, bogus=tree["embed"]))
    with pytest.raises(KeyError, match="no final_norm"):
        load_tree(named, {k: v for k, v in tree.items()
                          if k != "final_norm"})
