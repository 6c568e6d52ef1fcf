"""The benchmark of edlib_tpu_torch on one card: one cell, one run.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (its file under ``benchmark/configs/``) and a traffic
mix (``benchmark/traffic/<name>.json``), whose ``entry`` names the module
under ``benchmark/entries/`` that makes the inputs from the seed, calls the
program and checks its answers; each metric is read by
``benchmark/metrics/<name>.py``.  A run:

1. makes the inputs and warms the program on the first input of each
   distinct shape (``entry.shape``; the port builds its kernels into
   ``build/edlib_tpu_torch/`` of the checkout on its first use there, and
   the map_reads entry's first call builds its tuner and target index),
   which is the set-up (``setup_s``: process start to the first timed
   call);
2. drives the entry in a closed loop, one caller, cycling through the
   inputs, until the call in flight at ``--seconds`` returns (the window);
3. with ``--trace 1`` profiles the window (torch.profiler), keeps the
   kernels' operands and reads the per-layer metrics, else the end-to-end
   ones;
4. once the window has closed, its peak memory read and the program's
   state dropped, holds the window's answers against the plain reference
   (``benchmark/reference/``), and prints each number compared beside its
   limit on standard error and, last, one JSON line on standard output.

It exits non-zero and prints no result without the cards the cell asks
for, where the port does not come from this checkout, or where JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_PROCESS_START = time.time()

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
BANNED = ("jax", "jaxlib", "flax", "edlib_tpu")


class Refused(Exception):
    """The run cannot give a result (exit 2, no result line)."""


def banned_modules(names=None) -> list:
    """The banned top-level names among the loaded modules' (or names'),
    compared whole: edlib_tpu_torch is not edlib_tpu."""
    return sorted({m.split(".")[0] for m in list(names or sys.modules)}
                  & set(BANNED))


def load(path: Path):
    """A module of the benchmark by file (names may hold dots)."""
    name = "bench_" + "_".join(path.relative_to(HERE).with_suffix("")
                               .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str):
    """(cell, configuration, traffic) of a workload from BENCHMARK.json."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, cfg, traffic


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with trace its per-layer ones."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def card_sample() -> str:
    """nvidia-smi's name, power limit, SM clock and power draw."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def warm_inputs(entry) -> list:
    """The inputs the set-up calls: the first of each distinct shape."""
    first: dict = {}
    for i in range(entry.n_inputs):
        first.setdefault(entry.shape(i), i)
    return sorted(first.values())


def passed(checks: dict) -> bool:
    """Every number compared within its limit (sense "<=" or ">=")."""
    return all(v <= lim if sense == "<=" else v >= lim
               for v, lim, sense in checks.values())


class Context:
    """What the metric readers read: the window's calls, spans, device
    intervals, the kernels' operands and the k ladder's rungs."""

    def __init__(self, entry, calls, setup_s, window_s, trace, recorded,
                 rungs):
        self.entry = entry
        self.calls = calls          # [(i, start s, end s, answer)]
        self.setup_s = setup_s
        self.window_s = window_s
        self.trace = trace          # devtrace.Trace, or None untraced
        self.recorded = recorded    # {wrapper: [bound operands]} or None
        self.rungs = rungs          # ops.wavefront.take_rungs() of the window

    def work(self, key: str, attempted: bool = False) -> float:
        """The work of the window's calls that answered (with attempted:
        of every call) by the entry's count named key."""
        return sum(self.entry.work(i).get(key, 0)
                   for i, _, _, a in self.calls
                   if attempted or a is not None)

    def device_seconds(self, match) -> float:
        """Device seconds in the traced window of the kernels whose name
        satisfies match."""
        from benchmark import devtrace
        lo, hi = devtrace.window(self.trace)
        return sum(devtrace.by_name(self.trace.device, lo, hi,
                                    match).values())


def run(workload: str, seed: int, seconds: float, trace: bool,
        device=None, bench: dict = None, cfg=None, traffic=None,
        process_start: float = None, log=None) -> dict:
    """One run of a cell; returns the result line's object with the checks
    last.  device None is the card; the tests pass "cpu" (and a shrunken
    cfg and traffic) to drive the same path through the port's plain
    versions."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import devtrace, roofline
    from edlib_tpu_torch.ops import cuda_kernel as ck
    from edlib_tpu_torch.ops import wavefront as wf

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    start = _PROCESS_START if process_start is None else process_start
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg0, traffic0 = cell_spec(bench, workload)
    cfg, traffic = cfg or cfg0, traffic or traffic0
    on_card = device is None or torch.device(device).type == "cuda"
    t_imports = time.time() - start
    entry = load(HERE / "entries" / f"{traffic['entry']}.py").make(
        cfg, traffic, seed, device)
    t_inputs = time.time() - start
    for i in warm_inputs(entry):
        entry.call(i)
    if on_card:
        torch.cuda.synchronize()
    wf.take_rungs()
    setup_s = time.time() - start
    log(f"set-up {setup_s:.3f} s (imports {t_imports:.3f}, inputs "
        f"{t_inputs - t_imports:.3f}, warm calls {setup_s - t_inputs:.3f}); "
        f"card {card_sample() if on_card else '-'}")

    recorder = roofline.Recorder(ck) if trace else None
    prof = (profile(activities=[ProfilerActivity.CPU]
                    + ([ProfilerActivity.CUDA] if on_card else []))
            if trace else contextlib.nullcontext())
    calls = []
    try:
        with prof:
            if recorder is not None:
                recorder.on = True
            t_start = time.perf_counter()
            i = 0
            while True:
                with record_function("call"):
                    c0 = time.perf_counter()
                    try:
                        answer = entry.call(i)
                    except Exception:  # a failed call is counted, not fatal
                        log(f"call {i} failed:\n{traceback.format_exc()}")
                        answer = None
                    c1 = time.perf_counter()
                with record_function("between_calls"):
                    calls.append((i, c0, c1, answer))
                    i += 1
                    if c1 - t_start >= seconds:
                        break
    finally:
        if recorder is not None:
            recorder.restore()
    window_s = calls[-1][2] - t_start
    rungs = wf.take_rungs()
    durations = sorted(c1 - c0 for _, c0, c1, _ in calls)
    log(f"window {window_s:.3f} s, {len(calls)} calls of "
        f"{durations[0]:.4f}-{durations[len(calls) // 2]:.4f}-"
        f"{durations[-1]:.4f} s (min-median-max), the first "
        f"{calls[0][2] - calls[0][1]:.4f} s; card "
        f"{card_sample() if on_card else '-'}")
    found = banned_modules()
    if found:
        raise Refused(f"loaded after the window: {', '.join(found)}")

    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = devtrace.read(prof) if trace else None
    ctx = Context(entry, calls, setup_s, window_s, tr,
                  recorder.calls if trace else None, rungs)
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = load(HERE / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(mem_peak)}
    out = {"correct": None, "attempted": 0, "failed": 0, "metrics": metrics,
           "device": dev}
    if trace:
        lo, hi = devtrace.window(tr)
        dev["busy_s"] = devtrace.covered(tr.device, lo, hi)
        dev["window_s"] = hi - lo
        out["breakdown"] = devtrace.breakdown(tr)
    answers = [(i, a) for i, _, _, a in calls if a is not None]
    out["attempted"] = int(ctx.work(entry.unit, attempted=True))
    out["failed"] = int(sum(entry.work(i).get(entry.unit, 0)
                            for i, _, _, a in calls if a is None))
    del ctx, recorder, prof, tr, calls
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = entry.check(answers, "cuda" if on_card else device)
    checks["failed"] = (out["failed"], 0, "<=")
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    out["correct"] = passed(checks)
    out["checks"] = {name: {"value": v, "limit": lim, "sense": sense}
                     for name, (v, lim, sense) in checks.items()}
    found = banned_modules()
    if found:
        raise Refused(f"loaded: {', '.join(found)}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cell, _, _ = cell_spec(bench, args.workload)
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell['chips']}")
        # The checkout's root, not this folder, names the modules.
        sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                     if Path(q or ".").resolve() != HERE]
        import edlib_tpu_torch
        if ROOT not in Path(edlib_tpu_torch.__file__).resolve().parents:
            raise Refused("edlib_tpu_torch is not this checkout's: "
                          f"{edlib_tpu_torch.__file__}")
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  bench=bench)
    except (Refused, ImportError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['sense']} "
              f"{c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
