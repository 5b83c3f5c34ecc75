"""The port's op-cost counter (``launch/cost_analysis.py``) against the
reference's HLO cost analysis (``repro/launch/hlo_analysis.py``): flops of
loops of matmuls and of a SwiGLU layer, the per-rank collective bytes of
the hierarchical and bucketed reductions (8 gloo ranks; the reference's on
8 host devices in a subprocess), and the fusion rule for the kernels'
plain versions."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import hlo_analysis as ha
from repro.models import layers as ref_layers
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ssd_chunk as k4
from repro_torch.launch import cost_analysis as ca
from repro_torch.models import layers as ll

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_flops(fn, *args) -> float:
    return ha.analyze(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def test_loop_of_matmuls_equals_the_reference_scan():
    def scanned(x, w):
        out, _ = jax.lax.scan(lambda c, _: (jnp.dot(c, w), None), x, None,
                              length=10)
        return out
    z = jnp.zeros((128, 128))
    want = _ref_flops(scanned, z, z)

    def loop(x, w):
        for _ in range(10):
            x = x @ w
        return x
    t = torch.zeros(128, 128)
    got = ca.analyze(loop, t, t)
    assert got["flops"] == want == 2 * 128 ** 3 * 10
    assert got["collective_ops"] == {k: 0 for k in ca.COLLECTIVES}


def test_nested_loops_equal_the_reference_nested_scans():
    def nested(x, w):
        def outer(c, _):
            c2, _ = jax.lax.scan(lambda c2, _: (jnp.dot(c2, w), None), c,
                                 None, length=3)
            return c2, None
        out, _ = jax.lax.scan(outer, x, None, length=5)
        return out
    z = jnp.zeros((64, 64))
    want = _ref_flops(nested, z, z)

    def loops(x, w):
        for _ in range(5):
            for _ in range(3):
                x = torch.mm(x, w)
        return x
    t = torch.zeros(64, 64)
    assert ca.analyze(loops, t, t)["flops"] == want == 2 * 64 ** 3 * 15


def test_swiglu_flops_equal_the_reference():
    B, L, D, Fd = 2, 64, 256, 512
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         (("w_gate", (D, Fd)), ("w_in", (D, Fd)), ("w_out", (Fd, D)))}
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    want = _ref_flops(ref_layers.swiglu,
                      {k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x))
    got = ca.analyze(ll.swiglu, {k: torch.from_numpy(v)
                                 for k, v in p.items()}, torch.from_numpy(x))
    assert got["flops"] == want == 3 * 2 * B * L * D * Fd
    # every op reads its operands and writes its result: at least the
    # three products' operands and results
    assert got["bytes"] >= 4 * (3 * D * Fd + 2 * B * L * (D + Fd))


def test_a_kernels_plain_version_counts_as_one_fused_call():
    """K3 and K4 on CPU tensors: the plain version's flops (all of
    FlopCounterMode's count), and as bytes only the inputs and output."""
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 256, 4, 32, generator=g) for _ in range(3))
    with ca.CostCounter() as c:
        out = k3.flash_attention(q, k, v, causal=True, Bq=128, Bk=128)
    with FlopCounterMode(display=False) as fc:
        k3.flash_attention_plain(q, k, v, causal=True, Bk=128)
    assert c.flops == fc.get_total_flops() == 4 * 256 * 256 * 4 * 32
    assert c.bytes == 4 * 4 * q.numel()
    assert c.kernel_calls == {"flash_attention": 1}
    assert c.flops == ca.plain_flops(k3.flash_attention_plain, (q, k, v),
                                     causal=True)
    B, L, H, dh, N = 1, 256, 2, 8, 16
    ins = (torch.randn(B, L, H, dh, generator=g),
           torch.rand(B, L, H, generator=g),
           -torch.rand(H, generator=g), torch.randn(B, L, N, generator=g),
           torch.randn(B, L, N, generator=g), torch.ones(H))
    with ca.CostCounter() as c:
        y, state = k4.ssd_chunked(*ins, Q=128)
    with FlopCounterMode(display=False) as fc:
        k4.ssd_chunked_plain(*ins, Q=128)
    assert c.flops == fc.get_total_flops() > 0
    assert c.bytes == 4 * (sum(t.numel() for t in ins) + y.numel()
                           + state.numel())
    assert c.kernel_calls == {"ssd_chunked": 1}
    assert out.shape == q.shape


def test_live_bytes_and_peak():
    """Arguments held, then every storage an op makes until it is freed;
    a view makes none."""
    arg = torch.zeros(1000)
    with ca.CostCounter() as c:
        held = c.hold(arg)
        assert c.hold(arg[:10]) == 0
        a = torch.ones(256)
        b = (a * 2).view(16, 16)
        del a, b
        z = torch.zeros(10)
    assert held == 4000
    assert c.peak_bytes == 4000 + 2 * 1024
    assert c.live_bytes == 4000 + 40 and z.numel() == 10


_REF = """
import json, jax, jax.numpy as jnp
from repro.distributed.collectives import chunked_psum, hierarchical_psum
from repro.launch import hlo_analysis
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
tree = {"a": jnp.ones((128,)), "b": jnp.ones((5, 3))}
out = {}
for name, fn in (("hier", lambda t: hierarchical_psum(t, mesh)),
                 ("chunked", lambda t: chunked_psum(t, mesh,
                                                    ("pod", "data")))):
    r = hlo_analysis.analyze(jax.jit(fn).lower(tree).compile().as_text())
    out[name] = {"bytes": r["collective_bytes"], "ops": r["collective_ops"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_collectives():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF)],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def ranks():
    return torch_ranks.launch(8, "job_cost")


@pytest.mark.parametrize("name", ["hier", "chunked"])
def test_collective_bytes_equal_the_reference(ranks, ref_collectives, name):
    """Per-rank operand bytes and op counts of each kind: hierarchical
    reduce-scatter 576 B in 2 ops, all-reduce 288 B in 1 (XLA's combiner
    merges the two pieces; the port sends one buffer), all-gather 288 B in
    2; the bucketed one all-reduce of 572 B."""
    want = ref_collectives[name]
    for res in ranks:
        got = res[name]
        assert got["collective_bytes"] == want["bytes"]
        assert got["collective_ops"] == want["ops"]
    if name == "hier":
        assert want["bytes"]["reduce-scatter"] == 576
        assert want["bytes"]["all-reduce"] == 288
        assert want["bytes"]["all-gather"] == 288
    else:
        assert want["bytes"]["all-reduce"] == 572
        assert want["ops"]["all-reduce"] == 1
