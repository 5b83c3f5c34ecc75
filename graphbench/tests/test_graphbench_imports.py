"""What the benchmark loads: no module under graphbench/ brings in JAX or
the JAX package (top-level names compared whole: ``repro_torch`` is not
``repro``), the references import nothing of the port, and ``run.py``
exits non-zero, printing no result, without a card."""
import ast
import json
import subprocess
import sys

from graphbench import harness

PROBE = r"""
import contextlib, io, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from graphbench import harness
top = lambda: sorted({m.split(".")[0] for m in sys.modules})
for p in sorted((harness.BENCH / "reference").glob("*.py")):
    harness.load_module(p)
after_refs = top()
for p in sorted(harness.BENCH.rglob("*.py")):
    if "tests" not in p.parts:
        harness.load_module(p)
out = io.StringIO()
run = harness.load_module(harness.BENCH / "run.py")
with contextlib.redirect_stdout(out):
    rc = run.main(["--workload", "pr22-sem", "--seed", "1", "--seconds", "1"])
print(json.dumps({"after_refs": after_refs, "all": top(), "rc": rc,
                  "stdout": out.getvalue()}))
"""


def test_imports_and_no_card_exit():
    proc = subprocess.run([sys.executable, "-c", PROBE, str(harness.ROOT)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not set(got["all"]) & set(harness.FORBIDDEN)
    assert "repro_torch" not in got["after_refs"]
    assert "repro_torch" in got["all"]     # the apps drive the port
    assert got["rc"] != 0 and got["stdout"] == ""


def test_references_import_only_numpy_and_torch():
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= {
                "__future__", "numpy", "torch"}, (path.name, names)


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.apps.nmf", "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "repro.core.sem", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]
