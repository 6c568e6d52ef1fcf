"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names (edlib_tpu_torch begins with edlib_tpu); the plain
references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run as R

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"

# A run of every entry at a tiny size on the CPU, traced, in a fresh
# process; then the top-level names of every loaded module.
PROBE = r"""
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import run as R
bench = json.loads(open({bench!r}).read())
for wl in ("chr1m.nw", "ecoli.illumina150"):
    _, cfg, tr = R.cell_spec(bench, wl)
    if cfg["kind"] == "genome":
        cfg = dict(cfg, length=40000, repeats=[])
        tr = dict(tr, reads_per_call=200, batches=1,
                  sample=dict(tr["sample"], per_batch=8))
    else:
        cfg = dict(cfg, length=2000)
    R.run(wl, 3, 0.01, True, device="cpu", bench=bench, cfg=cfg,
          traffic=tr, process_start=time.time(), log=lambda m: None)
for m in bench["end_to_end"] + bench["per_layer"]:
    R.load(R.HERE / "metrics" / (m["name"] + ".py"))
import benchmark.controls
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(ROOT), bench=str(ROOT / "BENCHMARK.json"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(__import__("json").loads(res.stdout.strip().splitlines()[-1]))
    assert "edlib_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "edlib_tpu"}


def test_banned_names_are_whole():
    assert R.banned_modules(["edlib_tpu_torch", "edlib_tpu_torch.mapping",
                             "jaxlibx", "flaxen.y", "torch.jax"]) == []
    assert R.banned_modules(["edlib_tpu.ops", "jax.numpy", "jaxlib",
                             "flax"]) == ["edlib_tpu", "flax", "jax",
                                          "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_references_nothing_of_the_port():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        assert not set(_imports(p)) & {"jax", "jaxlib", "flax", "edlib_tpu"},\
            p
    for p in (HERE / "reference").glob("*.py"):
        assert set(_imports(p)) <= {"__future__", "typing", "numpy",
                                    "torch"}, p
