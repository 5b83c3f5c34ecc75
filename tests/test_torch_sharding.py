"""The port's sharding rules (``distributed/sharding.py``) and per-cell
policy (``launch/mesh.py``) against the reference's: the logical spec
table for every knob combination, ``sanitize_spec``, ``make_ctx``, and the
input, cache and parameter shardings of every arch x shape x mesh (the
reference's in a subprocess with 512 placeholder host devices)."""
import itertools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ARCH_IDS, SHAPES
from repro.configs.base import get_config as ref_config
from repro.distributed import sharding as ref_sh
from repro.launch import mesh as ref_mesh
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as pmesh
from repro_torch.models import model_api

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("act_btd", "act_btd_sp", "act_btf", "act_bthd", "act_bhts",
         "logits", "tokens", "kv_cache", "ssm_state", "p_embed", "p_norm",
         "p_attn_qkv", "p_attn_o", "p_mlp_in", "p_mlp_out", "p_router",
         "p_expert_in", "p_expert_out", "p_ssm_in", "p_ssm_out",
         "p_ssm_small", "p_conv", "moe_buf")


class StandIn:
    """A mesh's axis names and extents, all the policy functions read."""

    def __init__(self, multi: bool):
        self.axis_names = (("pod", "data", "model") if multi
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi else (16, 16)))


def norm(spec):
    """A spec as plain lists (JSON's form): None, a name, or names."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


@pytest.mark.parametrize("batch_axes", [("pod", "data"), ("data",)])
@pytest.mark.parametrize("attn_q_axis", ["heads", "hd", "seq", "none"])
@pytest.mark.parametrize("kv_axis", ["heads", "hd", "none"])
def test_spec_table_equals_the_reference(batch_axes, attn_q_axis, kv_axis):
    for fsdp, seq_dec, tp2 in itertools.product((False, True), repeat=3):
        kw = dict(batch_axes=batch_axes, fsdp=fsdp, seq_shard_decode=seq_dec,
                  kv_axis=kv_axis, attn_q_axis=attn_q_axis, expert_tp2=tp2)
        want = ref_sh.ShardingCtx(mesh=None, **kw)
        got = sh.ShardingCtx(mesh=None, **kw)
        for name in NAMES:
            assert norm(got.spec(name)) == norm(want.spec(name)), (name, kw)
            assert tuple(got.spec(name)) == tuple(want.spec(name))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_make_ctx_and_sanitize_equal_the_reference(multi):
    mesh = StandIn(multi)
    for arch, shape in itertools.product(ARCH_IDS, SHAPES):
        cell = SHAPES[shape]
        for knobs in ({}, {"fsdp": False}, {"seq_parallel": False}):
            want = ref_mesh.make_ctx(mesh, ref_config(arch), cell, **knobs)
            got = pmesh.make_ctx(mesh, get_config(arch), cell, **knobs)
            for f in ("batch_axes", "model_axis", "fsdp", "seq_shard_decode",
                      "seq_parallel", "kv_axis", "attn_q_axis",
                      "expert_tp2"):
                assert getattr(got, f) == getattr(want, f), (arch, shape, f)
        assert pmesh._batch_divisible(cell, mesh) == \
            ref_mesh._batch_divisible(cell, mesh)
    for shape in [(36, 64), (32, 64), (64, 36), (256, 3), (512, 32, 8)]:
        for spec in [("model", None), (("data", "model"), None),
                     (None, "model"), ("data", None, "model")]:
            if multi:
                spec = (("pod", "data"),) + spec[1:]
            want = ref_sh.sanitize_spec(shape, ref_sh.P(*spec), mesh)
            got = sh.sanitize_spec(shape, sh.P(*spec), mesh)
            assert norm(got) == norm(want), (shape, spec)


def test_to_placements_on_tuple_entries():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandIn(True)
    got = sh.to_placements(sh.P(("pod", "data"), None, "model"), mesh)
    assert got == [Shard(0), Shard(0), Shard(2)]
    assert sh.to_placements(sh.P(None, ("data",)), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    assert sh.to_placements(sh.P(("data", "model")), StandIn(False)) == \
        [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="axis order"):
        sh.to_placements(sh.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="used twice"):
        sh.to_placements(sh.P("data", "data"), mesh)


def test_annotations_return_their_input_without_a_context():
    x = torch.randn(2, 8, 4)
    assert sh.get_ctx() is None
    assert sh.shard(x, "act_btd") is x and sh.shard_seq(x) is x
    tree = {"wq": x}
    assert sh.gather_fsdp(tree, sh.ATTN_LOGICAL) is tree
    assert sh.named_sharding("act_btd") is None
    with sh.use_sharding(sh.ShardingCtx(mesh=StandIn(False),
                                        batch_axes=("data",))):
        assert sh.get_ctx() is not None
        assert sh.gather_fsdp(tree, sh.ATTN_LOGICAL) is tree   # fsdp off
    assert sh.get_ctx() is None


_REF = """
import json, jax
from repro.configs.base import ARCH_IDS, SHAPES, get_config
from repro.distributed.sharding import param_sharding_tree
from repro.launch.mesh import (cache_shardings, input_shardings, make_ctx,
                               make_production_mesh)
from repro.models import model_api

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

def paths(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], pre + (k,))
    else:
        yield ".".join(pre), tree

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, cell in SHAPES.items():
            ctx = make_ctx(mesh, cfg, cell)
            rec = {"inputs": {k: norm(v.spec) for k, v in
                              input_shardings(ctx, cfg, cell).items()},
                   "cache": {k: norm(v.spec) for k, v in
                             cache_shardings(ctx, cfg, cell).items()},
                   "params": {p: norm(s.spec) for p, s in paths(
                       param_sharding_tree(model_api.pdefs(cfg), ctx))}}
            out[f"{arch}|{shape}|{int(multi)}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_shardings():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], pre + (k,))
    else:
        yield ".".join(pre), tree


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_cache_and_param_shardings_equal_the_reference(
        ref_shardings, arch, multi):
    mesh = StandIn(multi)
    cfg = get_config(arch)
    for shape, cell in SHAPES.items():
        want = ref_shardings[f"{arch}|{shape}|{int(multi)}"]
        ctx = pmesh.make_ctx(mesh, cfg, cell)
        got = {"inputs": {k: norm(v.spec) for k, v in
                          pmesh.input_shardings(ctx, cfg, cell).items()},
               "cache": {k: norm(v.spec) for k, v in
                         pmesh.cache_shardings(ctx, cfg, cell).items()},
               "params": {p: norm(s.spec) for p, s in _paths(
                   sh.param_sharding_tree(model_api.pdefs(cfg), ctx))}}
        assert got == want, (arch, shape)
        # every placement list is one DTensor can take
        for s in _paths(sh.param_sharding_tree(model_api.pdefs(cfg), ctx)):
            assert len(s[1].placements) == len(mesh.axis_names)
