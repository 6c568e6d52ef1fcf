"""The value-adaptive reduce (hw_adaptive) on one NVIDIA card: its checks
and its times at each cluster size.

Builds the kernels, prints ptxas's registers and spills for the adaptive
kernel's instantiations, runs chip_smoke.py's two adaptive checks
(check_adaptive_kernel, check_adaptive_cluster: the kernel against its plain
version), then times chip_smoke's phase 23 operands (ADAPT_READS reads of
ADAPT_QLEN bp in one shared ADAPT_TLEN-bp target) at each k of ADAPT_KS with
C capped at 16, 8, 4, 2 and 1 (each cap's outputs and word-columns equal the
first's), the unbanded reduce_lanes on the same operands, and the first and
last k with band updates every 8, 64 and 512 columns (the boundaries'
share of the time).  Device times
are CUDA events around the kernel launches alone (chip_smoke.launch_ms).
Run from the root of the repository:

    python3 scripts/adaptive_cluster.py [--seed N] [--reps R]

Prints one JSON line; exits non-zero on any disagreement or without a card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("adaptive_cluster: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from edlib_tpu_torch.ops import _build
    from edlib_tpu_torch.ops import cuda_kernel as ck
    from edlib_tpu_torch.utils import hw

    dev = hw.resolve_device(None)
    card = hw.card_name_and_power()
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    ptxas, take = [], False
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            take = "hw_adaptive_cluster_kernel" in line
        if take:
            ptxas.append(line.strip())
    for line in ptxas:
        cs.log(f"ptxas: {line}")
    rng = np.random.RandomState(args.seed)
    for check in (cs.check_adaptive_kernel, cs.check_adaptive_cluster):
        t1 = time.perf_counter()
        check(rng, dev, ck)
        cs.log(f"{check.__name__}: equal, {time.perf_counter() - t1:.1f} s")

    t_ids = rng.randint(0, 4, cs.ADAPT_TLEN).astype(np.int32)
    reads, _ = cs.make_batch(rng, t_ids, 4, cs.ADAPT_READS, cs.ADAPT_QLEN, 0,
                             rate=0.06)
    nw = -(-cs.ADAPT_QLEN // 32)
    W = nw * 32 - cs.ADAPT_QLEN
    peq = ck.build_peq_device(
        torch.from_numpy(reads).to(dev),
        torch.full((cs.ADAPT_READS,), cs.ADAPT_QLEN, dtype=torch.int32,
                   device=dev), 4, nw)
    n = cs.ADAPT_READS
    tg = torch.full((1, cs.ADAPT_TLEN + W), 4, dtype=torch.int32, device=dev)
    tg[0, :cs.ADAPT_TLEN] = torch.from_numpy(t_ids).to(dev)
    lo = torch.full((n,), W, dtype=torch.int32, device=dev)
    hi = lo + cs.ADAPT_TLEN
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    lanes = (peq, tg, lo, hi, rows, rows * 0)
    unbanded_ms = cs.launch_ms(ck, lambda: ck.reduce_lanes(*lanes, 0),
                               args.reps)
    full = ck.reduce_lanes(*lanes, 0)
    result = dict(card=card, build_s=build_s, ptxas=ptxas,
                  unbanded_ms=unbanded_ms, ks={})
    tiles = n // 1024
    for k in cs.ADAPT_KS:
        first, per_c = None, {}
        for cap in (16, 8, 4, 2, 1):
            live = torch.zeros(tiles, dtype=torch.int64, device=dev)
            plan = {}
            out = ck.hw_adaptive(*lanes, k, 0, live=live, cluster=cap,
                                 plan=plan)
            got = [o.cpu() for o in out] + [live.cpu()]
            if first is None:
                first = got
                within = full[0].cpu() <= k
                for g, w in zip(got, full[:3]):
                    if not torch.equal(g[within], w.cpu()[within]):
                        cs.fail(f"k={k}: a lane within k differs from the "
                                "unbanded reduce")
                if (got[0][~within] <= k).any():
                    cs.fail(f"k={k}: a lane above k reported <= k")
            elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                cs.fail(f"k={k} cluster<={cap}: differs from the first cap")
            if plan["cluster"] != cap:
                continue                     # the card took a smaller C
            ms = cs.launch_ms(ck, lambda: ck.hw_adaptive(
                *lanes, k, 0, cluster=cap), args.reps)
            # chip_smoke.call_plan's bound of an hw_adaptive call.
            live_cols = int(first[3].sum())
            nbytes, _ = cs.lane_call_cost(peq.shape[1] * nw, tg, hi, rows,
                                          rows * 0, 4, 0, n * 3 * 4)
            ops = (live_cols * 1024 * cs.OPS_PER_WORD
                   + int(hi.long().clamp(0, tg.shape[1]).sum())
                   * cs.OPS_PER_COLUMN)
            per_c[cap] = dict(ms=ms, plan=plan,
                              bound_ms=cs.bound(nbytes, ops)[0],
                              live_word_cols=live_cols)
            cs.log(f"k={k} C={cap}: {ms:.2f} ms, plan {plan}, bound "
                   f"{per_c[cap]['bound_ms']:.2f} ms")
        result["ks"][k] = per_c
    result["unbanded_lanes_within"] = {
        k: int((full[0] <= k).sum()) for k in cs.ADAPT_KS}
    # The group boundaries' share: the same operands with band updates
    # every 64 and 512 columns (other bands, so other live word-columns)
    # beside every 8, at the card's own C.
    result["groups"] = {}
    for k in (cs.ADAPT_KS[0], cs.ADAPT_KS[-1]):
        for group in (8, 64, 512):
            live = torch.zeros(tiles, dtype=torch.int64, device=dev)
            ck.hw_adaptive(*lanes, k, 0, group, live=live)
            ms = cs.launch_ms(ck, lambda: ck.hw_adaptive(*lanes, k, 0, group),
                              args.reps)
            result["groups"][f"k{k}_g{group}"] = dict(
                ms=ms, boundaries=-(-cs.ADAPT_TLEN // group),
                live_word_cols=int(live.sum()))
            cs.log(f"k={k} group={group}: {ms:.2f} ms, "
                   f"{int(live.sum())} live word-columns")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
