"""The port's dense and VLM models on the CPU against the JAX package's, on
the same weights: reduced Yi-9B, Minitron-8B, MiniCPM-2B, Gemma2-27B (two
local layers of window 64 and two global ones, attention softcap 50, logit
softcap 30) and InternVL2-2B (8 projected patches before the text), 4
layers each.  The weights are the reference's parameter definitions drawn
with numpy from a seed (``test_torch_models.ref_tree``), carried over by
``convert.params_from_jax``.

Tolerances.  The port is held to the reference's jnp path (its dense stack
scans a traced window, so it never takes its Pallas kernel; the port's
global layers take K3's wrapper, whose plain version runs on the CPU) at
``test_torch_models.py``'s tolerances, forward 2e-4 and decode 1e-4, plus
twice the reference's own float32 spread on the same input: the largest
change of the reference's output, over SPREAD_DRAWS draws, when half of the
entries of each of its parameters move by one float32 ulp (``ulp.one_ulp``).
These reduced dense stacks amplify rounding (the reference's init gives
scores of magnitude in the hundreds, so its softmaxes are sharp): on
reduced Yi-9B at B = 2 that spread is 1.4e-3 of logits up to 4.4 at L = 128 and 6.4e-3 at
L = 384, where the port's distance from the reference is 7.2e-4 and
3.8e-3, so no float32 implementation that sums in another order meets 2e-4
alone.  The reference's own test of two attention implementations of this
forward allows 2e-3 (``tests/test_flash_kernel.py::
test_model_forward_pallas_matches_jnp``).  A wrong mask, softcap, window or
route moves logits by their own size.

Layer by layer the port meets 2e-4 and 1e-4 as they stand: each layer,
teacher-forced with the reference's own input to it, is held within the
tolerance of each entry and of its output's largest magnitude
(``check_layers``), for a prefill and for decode steps with their caches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_models import LOGIT_TOL, TOL, ref_tree
from ulp import one_ulp

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_config
from repro.models import layers as ref_ll
from repro.models import model_api as ref_api
from repro.models import transformer as ref_tf
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as k3
from repro_torch.models import layers
from repro_torch.models import model_api
from repro_torch.models import transformer as tf

ARCHS = ["yi-9b", "minitron-8b", "minicpm-2b", "gemma2-27b", "internvl2-2b"]
SPREAD_DRAWS = 4


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference cfg, reference params, port cfg, port model, the
    reference's params moved by ``one_ulp`` SPREAD_DRAWS times), on the
    same weights."""
    rcfg = ref_config(request.param).reduced()
    tree = ref_tree(rcfg, seed=0)
    cfg = get_config(request.param).reduced()
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(cfg, tree, "cpu"),
            [jax.tree.map(jnp.asarray, one_ulp(tree, seed))
             for seed in range(SPREAD_DRAWS)])


def batch(cfg, B, L, seed):
    """Tokens (and vlm's patches) as numpy, so that L is the attention's
    length: a vlm's text is L minus its patch prefix."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, L - cfg.n_patches))}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def assert_close(got, want, spread, tol, err_msg=""):
    """Within ``tol`` relative and absolute, beyond twice ``spread``."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol + 2 * spread, err_msg=err_msg)


def port_forward(cfg, model, b, **kw):
    return model_api.forward(model, cfg, {k: torch.from_numpy(v)
                                          for k, v in b.items()}, **kw)


def ref_forward(rcfg, params: list, b, **kw) -> list:
    """The reference's (logits, aux loss) for each params of the list,
    jitted (one compile for the params and their moved copies)."""
    fn = jax.jit(lambda p, bb: ref_api.forward(p, rcfg, bb, remat=False,
                                               **kw))
    bb = {k: jnp.asarray(v) for k, v in b.items()}
    return [(np.asarray(lg), float(aux)) for lg, aux in
            (fn(p, bb) for p in params)]


def spread(want, near) -> float:
    return max(float(np.abs(np.asarray(n) - want).max()) for n in near)


@pytest.fixture
def k3_calls(monkeypatch):
    """Calls of K3's wrapper, by (Bq, Bk)."""
    seen = []
    orig = k3.flash_attention

    def counted(q, k, v, **kw):
        seen.append((kw["Bq"], kw["Bk"]))
        return orig(q, k, v, **kw)
    monkeypatch.setattr(k3, "flash_attention", counted)
    return seen


def check_forward(pair, k3_calls, L):
    """The port's forward (B = 2) against the reference's; the K3 calls of
    the global layers, with blocks that divide L.  Returns the port's aux
    loss and the reference's."""
    rcfg, params, cfg, model, moved = pair
    b = batch(cfg, 2, L, seed=1)
    k3.reset_launches()
    got, aux = port_forward(cfg, model, b)
    assert got.shape == (2, L - cfg.n_patches, cfg.vocab_padded)
    assert k3.LAUNCHES["flash_attention"] == 0
    n_global = tf.layer_windows(cfg).count(0)
    assert k3_calls == [(min(L, 256) if L == 128 else 128,) * 2] * n_global
    (want, ref_aux), *near = ref_forward(rcfg, [params] + moved, b)
    assert_close(got.numpy(), want, spread(want, [n for n, _ in near]),
                 LOGIT_TOL)
    return float(aux), ref_aux


def check_last_only(pair):
    """``logits_last_only`` is the last row of the full logits (vlm: the
    last text position) and the reference's; the nn.Module's forward gives
    the same.  L = 100 takes the plain scan everywhere."""
    rcfg, params, cfg, model, moved = pair
    b = batch(cfg, 2, 100, seed=2)
    full, _ = port_forward(cfg, model, b)
    last, _ = port_forward(cfg, model, b, logits_last_only=True)
    assert last.shape == (2, 1, cfg.vocab_padded)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-6, atol=1e-6)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    assert torch.equal(model(tb["tokens"], tb.get("patches"),
                             last_only=True)[0], last)
    (want, _), *near = ref_forward(rcfg, [params] + moved, b,
                                   logits_last_only=True)
    assert_close(last.numpy(), want, spread(want, [n for n, _ in near]),
                 LOGIT_TOL)


def check_decode(pair, steps):
    """``steps`` teacher-forced decode steps, logits and caches, against
    the reference's jitted step (and the same steps on the ``one_ulp``
    weights for its spread)."""
    rcfg, params, cfg, model, moved = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, steps))
    ref_step = jax.jit(lambda p, c, t, pos: ref_api.decode_step(p, rcfg, c,
                                                                t, pos))
    runs = []                       # (logits a step, cache) per params
    for p in [params] + moved:
        c = ref_api.init_cache(rcfg, 2, steps + 8, dtype=jnp.float32)
        out = []
        for t in range(steps):
            lg, c = ref_step(p, c, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                             jnp.int32(t))
            out.append(np.asarray(lg))
        runs.append((np.stack(out), c))
    pc = model_api.init_cache(cfg, 2, steps + 8, dtype=torch.float32,
                              device="cpu")
    got = []
    for t in range(steps):
        lp, pc2 = model_api.decode_step(model, cfg, pc,
                                        torch.from_numpy(toks[:, t:t + 1]), t)
        assert pc2 is pc
        got.append(lp.numpy())
    (want, rc), *near = runs
    assert_close(np.stack(got), want, spread(want, [n for n, _ in near]),
                 TOL)
    for k in rc:
        w = np.asarray(rc[k])
        assert_close(pc[k].numpy(), w, spread(w, [c[k] for _, c in near]),
                     TOL, err_msg=k)


def assert_layer_close(got, want, tol, err_msg=""):
    """Within ``tol`` of each entry and of the layer output's largest
    magnitude: a layer's residual stream is tens in size, so its rounding
    is relative to that."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=err_msg)


def ref_layers(params) -> list:
    """The reference's stacked layer tree, one tree a layer."""
    n = jax.tree.leaves(params["layers"])[0].shape[0]
    return [jax.tree.map(lambda a, i=i: a[i], params["layers"])
            for i in range(n)]


def check_layers(pair, L, steps):
    """Teacher-forced, layer by layer: each of the port's layers
    (``transformer._attn_mlp_layer``) and the reference's on the same input,
    the reference's own input to that layer (its embedding, then its
    previous layer's output), held at the forward tolerance for a prefill of
    L (B = 2); then ``steps`` decode steps the same way, each layer with its
    own KV cache, held at the decode tolerance, the caches too."""
    rcfg, params, cfg, model, _ = pair
    b = {k: jnp.asarray(v) for k, v in batch(cfg, 2, L, seed=1).items()}
    windows = ref_tf.layer_windows(rcfg)
    rlps = ref_layers(params)
    fwd = jax.jit(lambda lp, x, w: ref_tf._attn_mlp_layer(
        rcfg, lp, x, jnp.arange(L), w, kv_chunk=L)[0])
    x = ref_ll.embed(params["embed"], b["tokens"])
    if cfg.family == "vlm":
        pe = jnp.einsum("bpd,de->bpe", b["patches"], params["patch_proj"])
        x = jnp.concatenate([pe.astype(x.dtype), x], axis=1)
    for i, (lp, rlp) in enumerate(zip(model.layers, rlps)):
        want = fwd(rlp, x, windows[i])
        got = tf._attn_mlp_layer(cfg, lp, torch.from_numpy(np.array(x)),
                                 torch.arange(L), lp.window, kv_chunk=L)[0]
        assert_layer_close(got.numpy(), want, LOGIT_TOL, f"layer {i}")
        x = want
    S = steps + 8
    dec = jax.jit(lambda lp, x, pos, w, c: ref_tf._attn_mlp_layer(
        rcfg, lp, x, pos + jnp.arange(1), w, cache=c, cache_pos=pos,
        kv_chunk=S)[::2])
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, steps))
    shape = (2, S, cfg.n_kv_heads, cfg.hd)
    rcaches = [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)} for _ in rlps]
    caches = [{"k": torch.zeros(shape), "v": torch.zeros(shape)}
              for _ in rlps]
    for t in range(steps):
        x = ref_ll.embed(params["embed"], jnp.asarray(toks[:, t:t + 1]))
        for i, (lp, rlp) in enumerate(zip(model.layers, rlps)):
            want, rcaches[i] = dec(rlp, x, jnp.int32(t), windows[i],
                                   rcaches[i])
            got = tf._attn_mlp_layer(
                cfg, lp, torch.from_numpy(np.array(x)),
                torch.arange(t, t + 1), lp.window, cache=caches[i],
                cache_pos=t, kv_chunk=S)[0]
            assert_layer_close(got.numpy(), want, TOL, f"step {t} layer {i}")
            x = want
    for i, (c, rc) in enumerate(zip(caches, rcaches)):
        for k in c:
            assert_layer_close(c[k].numpy(), rc[k], TOL, f"layer {i} {k}")


@pytest.mark.parametrize("L", [128, 384])
def test_forward_matches_reference(pair, k3_calls, L):
    """The global layers meet the kernel's conditions and call K3's wrapper
    (its plain version on the CPU, no launch), with blocks that divide L
    (L = 384: 128; the reference's Pallas toggle asserts there); gemma2's
    local layers take the plain scan, masking at L = 128 (window 64).
    vlm: the logits of the text only."""
    assert check_forward(pair, k3_calls, L) == (0.0, 0.0)


def test_last_only_and_module_interface(pair):
    check_last_only(pair)


def test_decode_matches_reference(pair):
    """gemma2 runs 72 steps, so that its local layers' window of 64 masks
    the cache."""
    check_decode(pair, 72 if pair[2].window else 8)


def test_layers_match_reference(pair):
    """Teacher-forced layers at the forward (2e-4) and decode (1e-4)
    tolerances; gemma2 decodes 72 steps, past its window of 64."""
    check_layers(pair, 128, 72 if pair[2].window else 8)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if ref_config(a).family != "audio"])
def test_layer_windows_are_the_references(arch):
    for cfg, rcfg in ((get_config(arch), ref_config(arch)),
                      (get_config(arch).reduced(),
                       ref_config(arch).reduced())):
        got = tf.layer_windows(cfg)
        assert all(type(w) is int for w in got)
        assert got == np.asarray(ref_tf.layer_windows(rcfg)).tolist()


def test_gelu_mlp_is_the_references():
    """The tanh-approximate GELU (``jax.nn.gelu``'s default)."""
    from repro.models import layers as ref_layers
    rng = np.random.default_rng(5)
    p = {"w_in": rng.standard_normal((16, 32)).astype(np.float32),
         "w_out": rng.standard_normal((32, 16)).astype(np.float32)}
    x = (3 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    got = layers.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x))
    want = ref_layers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
