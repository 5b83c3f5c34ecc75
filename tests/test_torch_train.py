"""The port's training pieces on the CPU against the JAX package's: the
token stream, the LR schedules, the global norm, clipping and one AdamW
update (with the weight-decay exemptions), the fault-tolerance helpers;
then the port's own trainer: loss decreasing, the non-finite rollback, the
launcher, ``remat``, and K3's and K4's autograd Functions.

Tolerances.  The schedules, the norm, the clip and the AdamW update are
float32 arithmetic in the reference's order; they are held within 4 ulps
(``ULP4``), the spread of ``pow``, ``cos`` and ``sqrt`` between libraries
and of a sum of per-tensor norms in another grouping.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_models import ref_tree

from repro.configs.base import get_config as ref_config
from repro.distributed import fault as ref_fault
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import TokenStream as RefTokenStream
from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.convert import load_tree, named_to_tree, params_from_jax
from repro_torch.distributed import fault
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.launch import train as launch_train
from repro_torch.models import encdec as ed
from repro_torch.models import model_api
from repro_torch.models import transformer as tf
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.loop import TrainConfig, Trainer

ULP4 = 4 * 2.0 ** -23


# -- data -------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=64, global_batch=4, seed=0),
    dict(vocab=50, seq_len=17, global_batch=6, seed=3, host_id=1, n_hosts=3),
    dict(vocab=122_753, seq_len=32, global_batch=2, seed=7, n_states=16)])
def test_token_stream_equals_reference(kw):
    """Batches, the stream position and a restore are the reference's."""
    ours, ref = TokenStream(DataConfig(**kw)), RefTokenStream(
        RefDataConfig(**kw))
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours.state_dict() == ref.state_dict()
    ours.load_state_dict({"next_index": 7, "seed": kw["seed"]})
    ref.load_state_dict({"next_index": 7, "seed": kw["seed"]})
    np.testing.assert_array_equal(next(ours)["tokens"], next(ref)["tokens"])


# -- optimizer --------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["wsd", "cosine", "const"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 3), (0, 50)])
def test_schedule_matches_reference(schedule, warmup, total):
    kw = dict(lr=3e-3, schedule=schedule, warmup_steps=warmup,
              total_steps=total)
    f, g = opt.schedule_fn(opt.AdamWConfig(**kw)), ref_opt.schedule_fn(
        ref_opt.AdamWConfig(**kw))
    steps = np.arange(total + 2, dtype=np.float32)
    got = np.array([float(f(torch.tensor(s))) for s in steps])
    want = np.array([float(g(jnp.float32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=ULP4, atol=0)


def _grad_tree(cfg, seed, scale=1.0):
    """A tree like the reference's parameters, standard normal * scale."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                        .astype(np.float32), ref_tree(cfg, 0))


def _named(model, tree):
    """``tree`` (the reference's stacked layout) keyed by the model's
    parameter names."""
    out = {k: torch.empty_like(p) for k, p in model.named_parameters()}
    load_tree(out, tree)
    return out


@pytest.fixture(scope="module")
def zamba():
    """Reduced Zamba2-7B: its tree has every decay-exempt tag (``ln``,
    ``final_norm``, ``dt_bias``, ``A_log``) and decaying leaves."""
    rcfg = ref_config("zamba2-7b").reduced()
    cfg = get_config("zamba2-7b").reduced()
    tree = ref_tree(rcfg, 0)
    return rcfg, cfg, tree, params_from_jax(cfg, tree, "cpu")


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_norm_and_clip_match_reference(zamba, scale):
    rcfg, cfg, _, model = zamba
    g = _grad_tree(rcfg, 1, scale)
    want, wn = jax.jit(ref_opt.clip_by_global_norm, static_argnums=1)(g, 1.0)
    got_norm = float(opt.global_norm(_named(model, g)))
    assert got_norm == pytest.approx(float(wn), rel=ULP4)
    got, gn = opt.clip_by_global_norm(_named(model, g), 1.0)
    assert float(gn) == pytest.approx(float(wn), rel=ULP4)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(
                named_to_tree(cfg, got))[0]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=ULP4, atol=1e-30,
                                   err_msg=jax.tree_util.keystr(path))


def test_adamw_update_matches_reference(zamba):
    """Two AdamW steps (bias corrections at steps 1 and 2, a clipped and an
    unclipped gradient) on the same parameters and gradients: parameters,
    moments and step within float32 rounding, updated in place."""
    rcfg, cfg, tree, _ = zamba
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = ref_opt.init_opt_state(rparams)
    model = params_from_jax(cfg, tree, "cpu")
    params = dict(model.named_parameters())
    state = opt.init_opt_state(params)
    mu0 = state.mu["embed"]
    ref_update = jax.jit(functools.partial(ref_opt.adamw_update,
                                           ref_opt.AdamWConfig(**oc)))
    for i, scale in enumerate((10.0, 1e-3)):
        g = _grad_tree(rcfg, 10 + i, scale)
        rparams, rstate, rm = ref_update(rparams, g, rstate)
        _, state, m = opt.adamw_update(opt.AdamWConfig(**oc), params,
                                       _named(model, g), state)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=ULP4)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=ULP4)
    assert state.mu["embed"] is mu0 and int(state.step) == int(rstate.step)
    assert state.step.dtype == torch.int32
    for want, got in ((rparams, params), (rstate.mu, state.mu),
                      (rstate.nu, state.nu)):
        got = named_to_tree(cfg, got)
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(want)[0],
                jax.tree_util.tree_flatten_with_path(got)[0]):
            a = np.asarray(a)
            np.testing.assert_allclose(
                b, a, rtol=ULP4, atol=ULP4 * float(np.abs(a).max()),
                err_msg=jax.tree_util.keystr(path))


def test_decay_exemptions_follow_the_reference_paths(zamba):
    """With zero gradients only weight decay moves a parameter: the leaves
    whose reference key path holds a ``_DECAY_EXEMPT`` tag stay put, the
    others shrink by lr * wd."""
    _, cfg, tree, _ = zamba
    model = params_from_jax(cfg, tree, "cpu")
    params = dict(model.named_parameters())
    before = {k: p.clone() for k, p in params.items()}
    oc = opt.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    opt.adamw_update(oc, params, {k: torch.zeros_like(p)
                                  for k, p in params.items()},
                     opt.init_opt_state(params))
    exempt = {k for k in params if not ref_opt._decays(
        opt.ref_keystr(k))}
    assert {k.split(".")[-1] for k in exempt} == {
        "ln", "ln1", "ln2", "final_norm", "dt_bias", "A_log"}
    for k, p in params.items():
        if k in exempt:
            assert torch.equal(p, before[k]), k
        else:
            torch.testing.assert_close(p, before[k] * (1 - 1e-2 * 0.5),
                                       rtol=ULP4, atol=0, msg=k)


# -- fault tolerance (the reference's test_distributed.py cases) ------------
def test_straggler_detector_flags_slow_steps():
    det = fault.StragglerDetector(fault.StragglerConfig(
        warmup_steps=5, patience=2, z_threshold=3.0))
    rng = np.random.default_rng(0)
    for _ in range(30):
        det.observe(1.0 + rng.normal(0, 0.01))
    s1 = det.observe(5.0)
    assert s1["z"] > 3.0 and s1["straggler"] == 0.0
    s2 = det.observe(5.0)
    assert s2["straggler"] == 1.0


def test_straggler_one_hiccup_does_not_poison():
    det = fault.StragglerDetector(fault.StragglerConfig(warmup_steps=5,
                                                        patience=3))
    for _ in range(20):
        det.observe(1.0)
    det.observe(50.0)  # single hiccup
    s = det.observe(1.0)
    assert s["straggler"] == 0.0 and abs(s["ewma"] - 1.0) < 0.1


def test_straggler_status_equals_the_references():
    ours, ref = fault.StragglerDetector(), ref_fault.StragglerDetector()
    rng = np.random.default_rng(5)
    times = np.concatenate([1 + rng.normal(0, 0.05, 40), [4, 4, 4, 1, 9],
                            1 + rng.normal(0, 0.05, 10)])
    for t in times:
        assert ours.observe(float(t)) == ref.observe(float(t))


def test_rebalance_elastic_plan_and_heartbeat():
    out = fault.rebalance_hint([1.0, 1.0, 2.0, 4.0], [8, 8, 8, 8])
    assert sum(out) == 32 and out[3] < out[0]
    assert out == ref_fault.rebalance_hint([1.0, 1.0, 2.0, 4.0], [8] * 4)
    assert fault.elastic_plan(512).shape == (2, 16, 16)
    assert fault.elastic_plan(300).shape == (16, 16)
    degraded = fault.elastic_plan(250)
    assert degraded.shape == (8, 16) and degraded.n_devices <= 250
    clock = {"t": 0.0}
    hb = fault.Heartbeat(4, timeout_s=10.0, now_fn=lambda: clock["t"])
    clock["t"] = 5.0
    for h in (0, 1, 2):
        hb.beat(h)
    clock["t"] = 12.0
    assert hb.dead_hosts() == [3]


# -- the trainer ------------------------------------------------------------
def test_trainer_loss_decreases():
    """The reference's test: 30 steps on the reduced minicpm config reduce
    the loss on the structured synthetic stream."""
    cfg = get_config("minicpm-2b").reduced()
    tr = Trainer(cfg, TrainConfig(steps=30, ckpt_dir=None, seed=0),
                 opt.AdamWConfig(lr=5e-3, schedule="const", warmup_steps=3,
                                 total_steps=30),
                 DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                            seed=0), device="cpu")
    tr.run()
    first = np.mean([m["loss"] for m in tr.metrics_log[:5]])
    lastm = np.mean([m["loss"] for m in tr.metrics_log[-5:]])
    assert lastm < first - 0.2, (first, lastm)


def _small_trainer(ckpt_dir, patience=3):
    cfg = get_config("mamba2-130m").reduced()
    return Trainer(cfg, TrainConfig(steps=2, ckpt_every=2, ckpt_dir=ckpt_dir,
                                    seed=1, nan_patience=patience),
                   opt.AdamWConfig(lr=1e-3, total_steps=20),
                   DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2,
                              seed=1), device="cpu")


def _nan_loss(monkeypatch, times=None):
    """Make the loss non-finite (``times`` calls, or all of them); returns
    the list of poisoned calls."""
    real, calls = model_api.loss_fn, []

    def poisoned(*a, **kw):
        loss, m = real(*a, **kw)
        if times is None or len(calls) < times:
            calls.append(1)
            loss = loss * float("nan")
            m = dict(m, loss=loss)
        return loss, m
    monkeypatch.setattr(model_api, "loss_fn", poisoned)
    return calls


def test_non_finite_loss_rolls_back(tmp_path, monkeypatch):
    """``nan_patience`` non-finite steps in a row restore the last sealed
    checkpoint (the step, the parameters, the moments, the stream
    position), and training goes on from there: the run ends where an
    uninterrupted one does, bit for bit."""
    tr = _small_trainer(str(tmp_path / "a"), patience=2)
    tr.run(2)
    calls = _nan_loss(monkeypatch, times=2)
    tr.run(2)     # step 3 bad (kept), the next bad: back to 2; then 3, 4
    monkeypatch.undo()
    assert len(calls) == 2 and tr.step == 4 and tr.data.next_index == 4
    losses = [m["loss"] for m in tr.metrics_log]
    assert [m["step"] for m in tr.metrics_log] == [1, 2, 3, 3, 4]
    assert np.isnan(losses[2]) and np.isfinite(losses[3:]).all()
    clean = _small_trainer(str(tmp_path / "b"))
    clean.run(4)
    assert [m["loss"] for m in clean.metrics_log][2:] == losses[3:]
    for k in tr.params:
        assert torch.equal(tr.params[k], clean.params[k]), k
        assert torch.equal(tr.opt_state.mu[k], clean.opt_state.mu[k]), k
        assert torch.equal(tr.opt_state.nu[k], clean.opt_state.nu[k]), k


def test_non_finite_loss_without_a_checkpoint_raises(monkeypatch):
    tr = _small_trainer(None, patience=2)
    _nan_loss(monkeypatch)
    with pytest.raises(FloatingPointError, match="no checkpoint"):
        tr.run(3)


def test_launcher_trains_on_the_cpu(capsys):
    assert launch_train.main(["--arch", "mamba2-130m", "--steps", "3",
                              "--batch", "2", "--seq", "32",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "done: step=3" in out


def test_trainer_and_launcher_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mamba2-130m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "mamba2-130m", "--steps", "1"])


@pytest.mark.parametrize("arch,layer_fn,tail", [
    ("zamba2-7b", "_mamba_apply", 1), ("whisper-medium", "_decoder_layer", 0),
    ("minicpm-2b", "_attn_mlp_layer", 0)])
def test_remat_recomputes_layers_with_equal_gradients(arch, layer_fn, tail,
                                                      monkeypatch):
    """``remat=True`` with grad enabled runs each layer body again in the
    backward pass (a hybrid's super-blocks, not its ``tail`` Mamba layers,
    as the reference checkpoints its scans), and the gradients equal those
    without it bit for bit; a serving forward runs each layer once."""
    cfg = get_config(arch).reduced()
    model = model_api.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    batch = model_api.make_batch(cfg, ShapeCell("t", 64, 2, "train"),
                                 np.random.default_rng(0), "cpu")
    module = ed if layer_fn == "_decoder_layer" else tf
    calls = []
    real = getattr(module, layer_fn)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(module, layer_fn, counted)
    model_api.forward(model, cfg, batch)
    n_layers = len(calls)
    model.requires_grad_(True)
    grads = []
    for remat in (False, True):
        calls.clear()
        model.zero_grad(set_to_none=True)
        loss, _ = model_api.loss_fn(model, cfg, batch, remat=remat)
        loss.backward()
        assert len(calls) == n_layers + (n_layers - tail) * remat
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


# -- K3 and K4 under autograd -----------------------------------------------
def test_flash_attention_function_gradients(monkeypatch):
    """The Function's backward (the plain version recomputed and
    differentiated) equals autograd through the plain version, with
    ``None`` for an input that needs no gradient; its forward is the
    launch (here stood in for by the plain version)."""
    launched = []

    def fake_launch(q, k, v, causal, softcap):
        launched.append(1)
        return k3.flash_attention_plain(q, k, v, causal=causal,
                                        softcap=softcap)
    monkeypatch.setattr(k3, "_launch", fake_launch)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 128, 4, 16), generator=gen) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    go = torch.randn((2, 128, 4, 16), generator=gen)
    for needs in ((True, True, True), (False, True, True)):
        ins = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        out = k3.FlashAttentionFn.apply(*ins, True, 20.0, 64)
        out.backward(go)
        ref = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), needs)]
        k3.flash_attention_plain(*ref, causal=True, softcap=20.0,
                                 Bk=64).backward(go)
        for a, b in zip(ins, ref):
            assert (a.grad is None) == (b.grad is None)
            if a.grad is not None:
                torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    assert len(launched) == 2


def test_ssd_function_gradients_through_y_and_state(monkeypatch):
    """As above for K4, through y and the final state together."""
    monkeypatch.setattr(k4, "_launch", lambda *a: k4.ssd_chunked_plain(
        *a[:6], Q=a[6]))
    gen = torch.Generator().manual_seed(1)
    B, L, H, dh, N = 2, 128, 3, 8, 16
    x = torch.randn((B, L, H, dh), generator=gen)
    dt = torch.rand((B, L, H), generator=gen) * 0.1 + 1e-3
    A = -(torch.rand((H,), generator=gen) + 0.5)
    Bm, Cm = (torch.randn((B, L, N), generator=gen) for _ in range(2))
    D = torch.randn((H,), generator=gen)
    gy = torch.randn((B, L, H, dh), generator=gen)
    gs = torch.randn((B, H, dh, N), generator=gen)
    grads = []
    for fn in (lambda *a: k4.SSDChunkedFn.apply(*a, 64),
               lambda *a: k4.ssd_chunked_plain(*a, Q=64)):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm, D)]
        y, s = fn(*ins)
        torch.autograd.backward((y, s), (gy, gs))
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_keep_the_plain_path_on_the_cpu():
    """On the CPU the wrappers run the plain versions under autograd (no
    Function, no launch), gradients included."""
    k3.reset_launches()
    q = torch.randn((1, 128, 2, 8), requires_grad=True)
    out = k3.flash_attention(q, q.detach(), q.detach(), Bq=128, Bk=128)
    assert not isinstance(out.grad_fn, type(None))
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None and k3.LAUNCHES["flash_attention"] == 0
    assert math.isfinite(float(q.grad.abs().sum()))
