"""Why MiniCPM-2B's loss does not fall in four steps at full depth: the
reference's own trainer stalls the same way, and for the same reason.

The reference's initialiser takes a weight's fan-in from its second-last
axis, which for ``wq``/``wk``/``wv`` (D, H, hd) is the head count: their
entries are sqrt(hd) = 8 times the 1/sqrt(D) scale, at any width with
64-wide heads.  Attention logits come out some 64 wide, and through 40
layers the first gradient's norm is 1e11 and more (6.8e16 at MiniCPM-2B's
full width on the card), almost all of it in the embedding.  Clipped to
norm 1, most other gradients fall below AdamW's eps, so the launcher's
four steps (lr 3e-3, WSD, one warm-up step) leave the loss wandering near
where it was, up or down as rounding takes it.  One layer of the same
width trains normally.

Both packages run those four steps from the same weights (the reference's
``make_train_step``; the port's ``Trainer`` restored from the reference's
step-0 checkpoint) at a reduced width with MiniCPM-2B's 64-wide heads, at
1 and at 40 layers.  At 40 layers float32 rounding decides the
trajectory: one-ulp moves of the weights move the reference's first loss
by about 0.02, its first gradient norm by a factor of up to 50, and its
loss after four steps by -0.18 to +0.03 from the first; the port's
40-layer runs on the CPU are not even bit-reproducible, and fell by -0.06
to +0.11 over runs under 1 to 8 threads.  So the first loss is held
within twice the reference's own spread over SPREAD_DRAWS such moves, and
the rest as properties both runs share: at 40 layers the first gradient
norm above 1e9 and a fall of less than 0.25, half of what one layer
falls; at one layer a norm below 100 and a fall of more than 0.3 (0.49
in both).

``python tests/test_torch_train_depth.py`` prints both runs' losses and
gradient norms at both depths, then the 40-layer fall of the reference
over five one-ulp draws and of the port under 1, 2, 4 and 8 threads.
"""
import dataclasses

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
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig

STEPS, SPREAD_DRAWS, WIDTH = 4, 2, 128
# the launcher's defaults for --steps 4
OPT = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=STEPS)


def _cfg(get, n_layers):
    return dataclasses.replace(
        get("minicpm-2b").reduced(), n_layers=n_layers, d_model=WIDTH,
        n_heads=WIDTH // 64, n_kv_heads=WIDTH // 64, head_dim=64,
        d_ff=WIDTH * 5 // 2)


def _data(cfg):
    return dict(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=0)


def _ref_steps(rcfg):
    """The reference's trainer at the launcher's settings, as a function of
    the starting weights and the step count: [(loss, grad_norm)] a step."""
    step = make_train_step(rcfg, ref_opt.AdamWConfig(**OPT), remat=True,
                           donate=False)

    def run(tree, steps=STEPS):
        params = jax.tree.map(jnp.asarray, tree)
        state = ref_opt.init_opt_state(params)
        stream = RefTokenStream(RefDataConfig(**_data(rcfg)))
        out = []
        for _ in range(steps):
            batch = {k: jnp.asarray(v) for k, v in next(stream).items()}
            params, state, m = step(params, state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out
    return run


def _port_steps(cfg, tree, ckpt_dir):
    """The port's ``Trainer``, restored from the reference's step-0
    checkpoint of ``tree`` written to the empty ``ckpt_dir``, over STEPS
    steps: [(loss, grad_norm)] a step."""
    p0 = jax.tree.map(jnp.asarray, tree)
    ref_ckpt.save(str(ckpt_dir), 0, {"params": p0,
                                     "opt": ref_opt.init_opt_state(p0)},
                  extra={"data_state": {"next_index": 0, "seed": 0}})
    tr = Trainer(cfg, TrainConfig(steps=STEPS, ckpt_dir=str(ckpt_dir)),
                 AdamWConfig(**OPT), DataConfig(**_data(cfg)), device="cpu")
    tr.run()
    return [(m["loss"], m["grad_norm"]) for m in tr.metrics_log]


def runs(n_layers, tmp_path):
    """(reference, port, spread): each run's [(loss, grad_norm)] a step,
    and the reference's first-loss spread under one-ulp weight moves."""
    rcfg, cfg = _cfg(ref_config, n_layers), _cfg(get_config, n_layers)
    tree = ref_tree(rcfg, 0)
    ref = _ref_steps(rcfg)
    want = ref(tree)
    spread = max(abs(ref(one_ulp(tree, s), 1)[0][0] - want[0][0])
                 for s in range(SPREAD_DRAWS))
    return want, _port_steps(cfg, tree, tmp_path), spread


@pytest.mark.parametrize("n_layers", [1, 40])
def test_depth_stalls_the_reference_and_the_port_alike(n_layers, tmp_path):
    want, got, spread = runs(n_layers, tmp_path)
    assert abs(got[0][0] - want[0][0]) <= 1e-5 * want[0][0] + 2 * spread, (
        got[0], want[0], spread)
    for run in (want, got):
        fall, norm = run[0][0] - run[-1][0], run[0][1]
        if n_layers == 1:
            assert norm < 100 and fall > 0.3, run
        else:
            assert norm > 1e9 and fall < 0.25, run


if __name__ == "__main__":
    import tempfile
    for n in (1, 40):
        with tempfile.TemporaryDirectory() as d:
            want, got, spread = runs(n, d)
        print(f"{n} layers, width {WIDTH}: first-loss spread {spread!r}")
        print("  reference (loss, grad_norm):", want)
        print("  port      (loss, grad_norm):", got)
    rcfg, cfg = _cfg(ref_config, 40), _cfg(get_config, 40)
    tree, ref = ref_tree(rcfg, 0), _ref_steps(rcfg)
    print(f"40 layers, width {WIDTH}: the loss's fall over {STEPS} steps")
    for s in range(5):
        r = ref(one_ulp(tree, s))
        print(f"  reference, one-ulp draw {s}: {r[0][0] - r[-1][0]!r}")
    for threads in (1, 2, 4, 8):
        torch.set_num_threads(threads)
        with tempfile.TemporaryDirectory() as d:
            g = _port_steps(cfg, tree, d)
        print(f"  port, {threads} threads: {g[0][0] - g[-1][0]!r}")
