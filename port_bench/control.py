"""The readings that a cell's correctness limits are set from, on the card.

    python3 -m port_bench.control --workload r720_8x --seeds 101,102 \\
        --control-seeds 201,202,203 --calls 2

In one process: for each of `--seeds`, the program driven through the
window's own call (`Driver.call`) on calls 0 .. calls-1 of that seed's clip
and weights, each call compared (`compare`) with the reference in float32
and at the configuration's stated precision; for each of
`--control-seeds` the same with the control in the program's place (the
reference one precision step lower: float8 convolutions where the
configuration states bf16, bf16 where it states float32). One JSON line a
seed, then the largest reading of each number over the program's seeds
(the lower reading) and the smallest over the control's (the upper).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .spec import load_cell, plugin


def readings(driver, mod, calls: int) -> dict:
    """The worst of each compared number over calls 0 .. calls-1."""
    outs = [driver.call(k) for k in range(calls)]
    ref, base = driver.reference(), driver.reference(stated=True)
    got = [mod.compare(o, driver.expected(ref, k), driver.expected(base, k))
           for k, o in enumerate(outs)]
    del ref, base
    return {n: max(g[n] for g in got) for n in got[0]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated program seeds")
    p.add_argument("--control-seeds", default="", help="comma-separated control seeds")
    p.add_argument("--calls", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = load_cell(args.workload)
    mod = plugin("drivers", cell.traffic["driver"])
    summary = {}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        seeds = [int(s) for s in seeds.split(",") if s]
        if not seeds:
            continue
        driver = mod.Driver(cell, seeds[0], "cuda", control=side == "control")
        driver.setup()
        rows = []
        for s in seeds:
            t = time.perf_counter()
            driver.reseed(s)
            r = readings(driver, mod, args.calls)
            rows.append(r)
            print(json.dumps({"workload": cell.name, "side": side, "seed": s, **r,
                              "seconds": time.perf_counter() - t}), flush=True)
        pick = max if side == "program" else min
        summary[side] = {n: pick(r[n] for r in rows) for n in rows[0]}
        driver.release()
    print(json.dumps({"workload": cell.name, "lower": summary.get("program"),
                      "upper": summary.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
