"""The controls of a cell's comparison, at the cell's own size, on a card.

    python3 benchmark/controls.py --workload <name> --seeds 1,2,3

For each seed: makes the cell's inputs as a run does, puts the reference's
control (reference/hw_map.py cut into tiles with no overlap, or
reference/nw_wfa.py held to the k ladder's first band) in the program's
place, and prints the numbers the cell compares beside their limits.  The
program is not called.  A control has to come out not correct on every
seed; the readings set the limits' upper ends (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve()
                                 != ROOT / "benchmark"]
    import torch
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import run as R
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic = R.cell_spec(bench, args.workload)
    entry_mod = R.load(R.HERE / "entries" / f"{traffic['entry']}.py")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        entry = entry_mod.make(cfg, traffic, seed, None)
        checks = entry.check([], "cuda", control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": R.passed(checks),
                          "checks": {k: v[0] for k, v in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
