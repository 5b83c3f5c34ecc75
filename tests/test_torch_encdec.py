"""The port's encoder-decoder on the CPU against the JAX package's: reduced
Whisper-medium (2 encoder and 4 decoder layers, d_model 64, 32 frames), on
the reference's parameter definitions drawn with numpy
(``test_torch_models.ref_tree``), carried over by ``params_from_jax``.

``encode`` (bidirectional attention over the frames, the plain chunk scan)
and ``encdec_forward`` (the decoder's causal self-attention through K3's
wrapper at L = 128, its cross-attention through the plain scan) are held at
2e-4, ``encdec_precompute_cross`` then ``encdec_decode_step`` at 1e-4, each
beyond twice the reference's own spread when half of the entries of each
parameter and of the frames move by one float32 ulp, as in
``test_torch_dense.py``.  This stack amplifies rounding more than the dense ones: fed the reference's
input, a decoder layer of the port differs from the reference's by 1e-4 to
1.1e-3 (of a residual stream of 32 to 65), and through the 4 layers the
difference grows to 0.77 before the final norm: the port's logits differ
from the reference's by 0.044 (of magnitude up to 4.5), its own spread is
0.040.  Teacher-forced, each layer of the encoder and the decoder is held
at 2e-4 (a prefill) and 1e-4 (decode steps) of its output's scale, with no
spread (``test_layers_match_reference``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from test_torch_dense import (assert_close, assert_layer_close,
                              k3_calls,  # noqa: F401 (a fixture)
                              spread)
from test_torch_models import LOGIT_TOL, TOL, ref_tree
from ulp import one_ulp

from repro.configs.base import get_config as ref_config
from repro.models import encdec as ref_ed
from repro.models import layers as ref_ll
from repro.models import model_api as ref_api
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import encdec, model_api

ARCH = "whisper-medium"
DRAWS = 4


@pytest.fixture(scope="module")
def pair():
    rcfg = ref_config(ARCH).reduced()
    tree = ref_tree(rcfg, seed=0)
    cfg = get_config(ARCH).reduced()
    return (rcfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(cfg, tree, "cpu"),
            [jax.tree.map(jnp.asarray, one_ulp(tree, seed))
             for seed in range(DRAWS)])


def frames(cfg, B=2, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def moved_frames(f, seed):
    return one_ulp(f, 100 + seed)


def test_encode_matches_reference(pair):
    rcfg, params, cfg, model, _ = pair
    f = frames(cfg)
    got = encdec.encode(model, cfg, torch.from_numpy(f))
    run = jax.jit(lambda p, x: ref_ed.encode(p, rcfg, x, remat=False))
    want = np.asarray(run(params, jnp.asarray(f)))
    near = [run(params, jnp.asarray(moved_frames(f, s))) for s in range(DRAWS)]
    assert got.shape == f.shape
    assert_close(got.numpy(), want, spread(want, near), LOGIT_TOL)


def test_forward_matches_reference(pair, k3_calls):
    """B = 2, L = 128 tokens over 32 frames: the decoder's 4 self-attention
    layers call K3's wrapper (blocks of 128), the rest is plain."""
    rcfg, params, cfg, model, moved = pair
    f = frames(cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 128))
    got, aux = model_api.forward(model, cfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(f)})
    assert got.shape == (2, 128, cfg.vocab_padded) and float(aux) == 0.0
    assert k3_calls == [(128, 128)] * cfg.n_layers
    run = jax.jit(lambda p, b: ref_api.forward(p, rcfg, b, remat=False)[0])
    want = np.asarray(run(params, {"tokens": jnp.asarray(toks),
                                   "frames": jnp.asarray(f)}))
    near = [run(p, {"tokens": jnp.asarray(toks),
                    "frames": jnp.asarray(moved_frames(f, s))})
            for s, p in enumerate(moved)]
    assert_close(got.numpy(), want, spread(want, near), LOGIT_TOL)
    last, _ = model_api.forward(model, cfg, {
        "tokens": torch.from_numpy(toks), "frames": torch.from_numpy(f)},
        logits_last_only=True)
    torch.testing.assert_close(last, got[:, -1:], rtol=1e-6, atol=1e-6)


def test_precompute_cross_then_decode_matches_reference(pair):
    """The encoder's memory projected once into the cross cache, then 8
    teacher-forced decode steps: logits, self caches and cross caches."""
    rcfg, params, cfg, model, moved = pair
    f = frames(cfg)
    steps, S = 8, 16
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, steps))
    ref_step = jax.jit(lambda p, c, t, pos: ref_api.decode_step(p, rcfg, c,
                                                                t, pos))
    runs = []
    for p, fr in zip([params] + moved,
                     [f] + [moved_frames(f, s) for s in range(DRAWS)]):
        mem = ref_ed.encode(p, rcfg, jnp.asarray(fr), remat=False)
        c = dict(ref_api.init_cache(rcfg, 2, S, dtype=jnp.float32),
                 **ref_ed.encdec_precompute_cross(p, rcfg, mem))
        out = []
        for t in range(steps):
            lg, c = ref_step(p, c, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                             jnp.int32(t))
            out.append(np.asarray(lg))
        runs.append((np.stack(out), c))
    mem = encdec.encode(model, cfg, torch.from_numpy(f))
    cache = model_api.init_cache(cfg, 2, S, dtype=torch.float32, device="cpu")
    cache.update(encdec.encdec_precompute_cross(model, cfg, mem))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: s.shape for k, s in model_api.cache_shapes(
            cfg, 2, S, dtype=torch.float32).items()}
    got = []
    for t in range(steps):
        lg, c2 = model_api.decode_step(model, cfg, cache,
                                       torch.from_numpy(toks[:, t:t + 1]), t)
        assert c2 is cache
        got.append(lg.numpy())
    (want, rc), *near = runs
    assert_close(np.stack(got), want, spread(want, [n for n, _ in near]),
                 TOL)
    for k in rc:
        w = np.asarray(rc[k])
        assert_close(cache[k].numpy(), w, spread(w, [c[k] for _, c in near]),
                     TOL, err_msg=k)


def ref_encoder_layer(rcfg, lp, x):
    """The reference's encoder layer (the body of its ``encode`` scan),
    from its layer functions."""
    positions = jnp.arange(x.shape[1])
    h = ref_ll.rmsnorm(x, lp["ln1"], rcfg.norm_eps)
    y, _ = ref_ll.attention(lp["attn"], h, n_heads=rcfg.n_heads,
                            n_kv=rcfg.n_kv_heads, hd=rcfg.hd,
                            rope_theta=rcfg.rope_theta, positions=positions,
                            causal=False, kv_chunk=min(1024, x.shape[1]))
    x = x + y
    h = ref_ll.rmsnorm(x, lp["ln2"], rcfg.norm_eps)
    return x + ref_ll.gelu_mlp(lp["mlp"], h)


def stack_layers(tree) -> list:
    n = jax.tree.leaves(tree)[0].shape[0]
    return [jax.tree.map(lambda a, i=i: a[i], tree) for i in range(n)]


def test_layers_match_reference(pair):
    """Teacher-forced, layer by layer, each fed the reference's own input
    to it: the encoder's layers over the frames and the decoder's (L = 128
    over the reference's encoder memory) at the forward tolerance (2e-4),
    then 8 decode steps of the decoder's layers, each with its self cache
    and the reference's cross cache, at the decode tolerance (1e-4)."""
    rcfg, params, cfg, model, _ = pair
    x = jnp.asarray(frames(cfg))
    enc = jax.jit(lambda lp, x: ref_encoder_layer(rcfg, lp, x))
    for i, (lp, rlp) in enumerate(zip(model.encoder,
                                      stack_layers(params["encoder"]))):
        want = enc(rlp, x)
        got = encdec._encoder_layer(cfg, lp, torch.from_numpy(np.array(x)),
                                    torch.arange(x.shape[1]))
        assert_layer_close(got.numpy(), want, LOGIT_TOL, f"encoder {i}")
        x = want
    memory = ref_ed.encode(params, rcfg, jnp.asarray(frames(cfg)),
                           remat=False)
    mem = torch.from_numpy(np.array(memory))
    L = 128
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, L))
    fwd = jax.jit(lambda lp, x: ref_ed._decoder_layer(
        rcfg, lp, x, jnp.arange(L), memory, kv_chunk=L)[0])
    rlps = stack_layers(params["decoder"])
    x = ref_ll.embed(params["embed"], jnp.asarray(toks))
    for i, (lp, rlp) in enumerate(zip(model.decoder, rlps)):
        want = fwd(rlp, x)
        got = encdec._decoder_layer(cfg, lp, torch.from_numpy(np.array(x)),
                                    torch.arange(L), mem, kv_chunk=L)[0]
        assert_layer_close(got.numpy(), want, LOGIT_TOL, f"decoder {i}")
        x = want
    steps, S = 8, 16
    cross = ref_ed.encdec_precompute_cross(params, rcfg, memory)
    dec = jax.jit(lambda lp, x, pos, c, ck, cv: ref_ed._decoder_layer(
        rcfg, lp, x, pos + jnp.arange(1), None, self_cache=c,
        cross_cache={"k": ck, "v": cv}, cache_pos=pos, kv_chunk=S))
    shape = (2, S, cfg.n_kv_heads, cfg.hd)
    rcaches = [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)} for _ in rlps]
    caches = [{"k": torch.zeros(shape), "v": torch.zeros(shape)}
              for _ in rlps]
    for t in range(steps):
        x = ref_ll.embed(params["embed"], jnp.asarray(toks[:, t:t + 1]))
        for i, (lp, rlp) in enumerate(zip(model.decoder, rlps)):
            ck, cv = cross["cross_k"][i], cross["cross_v"][i]
            want, rcaches[i] = dec(rlp, x, jnp.int32(t), rcaches[i], ck, cv)
            got = encdec._decoder_layer(
                cfg, lp, torch.from_numpy(np.array(x)),
                torch.arange(t, t + 1), None, self_cache=caches[i],
                cross_cache={"k": torch.from_numpy(np.array(ck)),
                             "v": torch.from_numpy(np.array(cv))},
                cache_pos=t, kv_chunk=S)[0]
            assert_layer_close(got.numpy(), want, TOL, f"step {t} layer {i}")
            x = want
    for i, (c, rc) in enumerate(zip(caches, rcaches)):
        for k in c:
            assert_layer_close(c[k].numpy(), rc[k], TOL, f"layer {i} {k}")
