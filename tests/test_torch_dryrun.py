"""The port's dry run (``launch/dryrun.py``) on 256 placeholder ranks,
reduced: one config of each family (dense and moe here; vlm and encdec in
``test_torch_dryrun_media.py``, ssm and hybrid in
``test_torch_dryrun_{ssm,hybrid}.py``) at widths that a 16-way axis
divides, x train, prefill and decode at small sizes, each cell in a
process of its own (a process holds one placeholder group).
Every cell must be ``ok`` with the reference's ``model_flops``, a useful
ratio in (0, 1.05], collective bytes in FSDP training and positive memory;
``roofline.markdown_table`` must equal the reference's on the same records
in every column but the hint."""
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import get_config as ref_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"dense": "minicpm-2b", "moe": "olmoe-1b-7b"}
CELLS = {"train_4k": ShapeCell("train_4k", 128, 32, "train"),
         "prefill_32k": ShapeCell("prefill_32k", 128, 16, "prefill"),
         "decode_32k": ShapeCell("decode_32k", 128, 32, "decode")}
# the prefill with every position's logits, so that 2·N·D counts what
# runs (the serving prefill's last-position unembedding counts 1/L of it);
# sequence parallelism off (it triples the time DTensor spends planning
# here; the full-size table and the card's dry run take it)
POLICY = {"train_4k": "no_seq_parallel",
          "prefill_32k": "full_logits,no_seq_parallel"}
# reduced widths a 16-way model axis divides; two layers (the hybrid: one
# super-block, the shared attention block and two Mamba layers), and as
# many encoder frames as decoder tokens
WIDTHS = dict(d_model=256, n_heads=16, n_kv_heads=16, head_dim=16,
              d_ff=512, moe_d_ff=128, vocab=256, n_layers=2,
              n_enc_layers=1, enc_frames=128)


def _cfg(get, arch):
    import dataclasses
    cfg = get(arch).reduced()
    kw = dict(WIDTHS)
    if cfg.family == "dense":
        kw.update(n_kv_heads=4)       # GQA: 4 KV heads on a 16-way axis
    if cfg.family == "moe":
        kw.update(n_experts=16, top_k=2)
    if cfg.family == "hybrid":
        kw.update(n_layers=2, attn_every=2)
    return dataclasses.replace(cfg, **kw)


_RUN = """
import json, sys
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun
sys.path.insert(0, {tests!r})
from test_torch_dryrun import CELLS, POLICY, _cfg
rec = dryrun.run_cell({arch!r}, {shape!r}, "single", out_dir={out!r},
                      verbose=False, cfg=_cfg(get_config, {arch!r}),
                      cell=CELLS[{shape!r}], policy=POLICY.get({shape!r}))
rec.pop("traceback", None)
print(json.dumps(rec))
"""


def _run(arch, shape, out):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    code = textwrap.dedent(_RUN).format(tests=os.path.join(ROOT, "tests"),
                                        arch=arch, shape=shape, out=str(out))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])


def run_families(families: dict, out) -> dict:
    """family -> its cells' records, each cell in a process of its own,
    all at once."""
    jobs = [(f, a, s) for f, a in families.items() for s in CELLS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        recs = list(ex.map(lambda j: _run(j[1], j[2], out), jobs))
    out = {f: [] for f in families}
    for (f, _, _), rec in zip(jobs, recs):
        out[f].append(rec)
    return out


def n_params(cfg) -> int:
    from repro.models import model_api as ref_api
    return ref_api.n_params(cfg)


def n_encoder(cfg) -> int:
    """The parameters only the encoder uses."""
    import math
    from repro.models import model_api as ref_api
    tree = ref_api.pdefs(cfg)
    leaves = jax.tree.leaves({"e": tree["encoder"],
                              "n": tree["enc_final_norm"]},
                             is_leaf=lambda x: hasattr(x, "shape"))
    return sum(math.prod(d.shape) for d in leaves)


def check_family(records, family, arch):
    # the reference's model_flops, with its XLA_FLAGS side effect undone
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import model_flops as ref_model_flops
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    rcfg = _cfg(ref_config, arch)
    for rec in records[family]:
        assert rec["status"] == "ok", rec.get("error")
        cell = CELLS[rec["shape"]]
        assert rec["model_flops"] == ref_model_flops(rcfg, cell)
        t = rec["terms"]
        bound = 1.05
        if rcfg.is_encdec and cell.kind == "decode":
            # 2·N·B counts the encoder's parameters, which decode (on a
            # cached encoder memory) does not run
            bound *= n_params(rcfg) / (n_params(rcfg) - n_encoder(rcfg))
        assert 0 < t["useful_flop_ratio"] <= bound, (rec["shape"], t)
        assert rec["n_devices"] == 256
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["memory"]["peak_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"]
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        coll = sum(rec["collective_bytes"][k] for k in
                   ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all"))
        if rec["kind"] == "train":
            assert rec["sharding"]["fsdp"] and coll > 0
        assert set(rec["omitted"]) >= {"raw_cost_analysis", "hlo_ops"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return run_families(FAMILIES, tmp_path_factory.mktemp("dryrun"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_kind_counts_ok(records, family):
    check_family(records, family, FAMILIES[family])


def test_roofline_table_equals_the_reference(records):
    recs = [r for rs in records.values() for r in rs]
    recs.append({"arch": "x", "shape": "train_4k", "mesh": "single",
                 "status": "error", "error": "RuntimeError: no rule"})
    recs.append({"arch": "y", "shape": "long_500k", "mesh": "multi",
                 "status": "skipped", "reason": "quadratic"})
    got = [ln.split(" | ")[:-1] for ln in
           roofline.markdown_table(recs).splitlines()]
    want = [ln.split(" | ")[:-1] for ln in
            ref_roofline.markdown_table(recs).splitlines()]
    assert got == want
    assert roofline.COLUMNS == ref_roofline.COLUMNS
    assert set(roofline.HINTS) == set(ref_roofline.HINTS)


@pytest.mark.parametrize("src,dst,dims", [
    ((2, 3, 4), (6, 4), {1}), ((2, 3, 4), (2, 12), {2}),
    ((2, 3, 4), (24,), {1, 2}), ((32, 128, 16, 16), (32, 128, 4, 4, 16),
                                 {2}),
    ((2, 1, 4), (2, 4), set()), ((4, 1, 16, 64), (64, 64), {2}),
    ((8, 16), (8, 16), set()), ((256, 4096, 1536), (256, 4096, 24, 64),
                                {2}), ((2, 4), (2, 1, 4), set())])
def test_view_dims_to_gather(src, dst, dims):
    """The dims a view merges other than as a group's first, or splits:
    what the dry run gathers first where DTensor cannot keep them
    sharded."""
    from repro_torch.launch.dryrun import view_dims_to_gather
    assert view_dims_to_gather(src, dst) == dims
