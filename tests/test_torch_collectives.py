"""The port's explicit collectives (``distributed/collectives.py``) on 8
gloo ranks against numpy and the reference: hierarchical and bucketed
means of distinct per-rank values, int8 quantization bit for bit, and the
compressed cross-pod reduction on the reference test's input (the
reference's on 8 host devices in a subprocess)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.distributed.collectives import quantize_int8 as ref_quantize
from repro_torch.distributed.collectives import (dequantize_int8,
                                                 quantize_int8)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.default_rng(0)
    return {"distinct": {
        "a": rng.standard_normal((8, 128)).astype(np.float32),
        "b": rng.standard_normal((8, 5, 3)).astype(np.float32)},
        # the reference test's input (tests/test_distributed.py)
        "w": np.random.default_rng(0).standard_normal((64,))
        .astype(np.float32)}


@pytest.fixture(scope="module")
def ranks():
    return torch_ranks.launch(8, "job_collectives", _inputs())


def _group_mean(values, rank, axes):
    """The numpy mean of ``values`` (8, ...) over the ranks that share
    ``rank``'s coordinates off ``axes`` of the (2, 2, 2) ("pod", "data",
    "model") mesh (rank = 4 pod + 2 data + model)."""
    coord = np.unravel_index(rank, (2, 2, 2))
    names = ("pod", "data", "model")
    members = [r for r in range(8)
               if all(np.unravel_index(r, (2, 2, 2))[i] == coord[i]
                      for i, n in enumerate(names) if n not in axes)]
    return values[members].astype(np.float64).mean(0)


def test_hierarchical_psum_is_the_mean_over_pod_and_data(ranks):
    inp = _inputs()["distinct"]
    for r, res in enumerate(ranks):
        for k, v in inp.items():
            want = _group_mean(v, r, ("pod", "data"))
            assert res["hier"][k].shape == v.shape[1:]
            np.testing.assert_allclose(res["hier"][k], want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("axes", [("pod", "data"), ("data",)])
def test_chunked_psum_is_the_mean_over_its_axes(ranks, axes):
    inp = _inputs()["distinct"]
    for r, res in enumerate(ranks):
        got = res[f"chunked_{'_'.join(axes)}"]
        for k, v in inp.items():
            np.testing.assert_allclose(got[k], _group_mean(v, r, axes),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,shape,scale", [
    (0, (64,), 1.0), (1, (1000,), 1e-3), (2, (17, 33), 50.0),
    (3, (4096,), 1e4), (4, (7,), 1e-30)])
def test_quantize_int8_equals_the_reference_bit_for_bit(seed, shape, scale):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = ref_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    d = dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(d, np.asarray(rq, np.float32) *
                                  np.asarray(rs))
    # half a step, beyond float32's rounding of x / scale and q * scale
    # (each up to an ulp of 127, 2**-17 of a step)
    assert np.abs(d - x).max() <= s.item() / 2 * (1 + 2 ** -14)


_REF = """
import json, jax, jax.numpy as jnp, numpy as np
from repro.distributed.collectives import (compressed_pod_psum,
                                           init_error_state)
mesh = jax.make_mesh((2, 4), ("pod", "data"))
g = {"w": jnp.asarray(np.random.default_rng(0).standard_normal((64,)),
                      jnp.float32)}
out, err = compressed_pod_psum(g, mesh, init_error_state(g, mesh))
print(json.dumps({"out": np.asarray(out["w"]).tolist(),
                  "err": np.asarray(err["w"]).tolist()}))
"""


def test_compressed_pod_psum_equals_the_reference(ranks):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.splitlines()[-1])
    want = np.asarray(ref["out"], np.float32)
    w = _inputs()["w"]
    for res in ranks:
        # every rank holds the same mean; the sums of four equal values
        # may round in another order than XLA's (a few ulps)
        np.testing.assert_allclose(res["compressed"], want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res["compressed"], w, atol=0.05)
    # the reference returns device 0's residual (out_specs P()): rank 0's
    np.testing.assert_allclose(ranks[0]["compressed_err"],
                               np.asarray(ref["err"], np.float32),
                               rtol=1e-5, atol=1e-6)
    # the residual is what quantization left: below half an int8 step of
    # the reduce-scatter piece (4 w, 16 values a data rank)
    step = 4 * np.abs(w).max() / 127
    for res in ranks:
        assert np.abs(res["compressed_err"]).max() <= step / 2 * (1 + 2 ** -14)
