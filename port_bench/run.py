"""Run one cell of the port's benchmark once, on the card.

    python3 -m port_bench.run --workload r720_8x --seed 7 --seconds 40 --trace 0

From the root of a checkout. Prints as its last line one JSON object with
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device` (with `--trace 1`
also `busy_s` and `window_s`; and `breakdown`) and, last, `checks`: each
correctness number with its limit, also printed as the last lines of
standard error. Exits non-zero, printing no result, without a CUDA card,
with fewer cards than the cell asks for, or when `jax`, `jaxlib`, `flax`,
`optax` or the JAX package `gimmvfi_tpu` is loaded once the window has
closed.

The kernels that nvcc builds stay in the port's `build/kernels/` inside
the checkout, so only a checkout's first run builds them.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gimmvfi_tpu")


def loaded_forbidden() -> list[str]:
    """Modules in `sys.modules` whose top-level name, the part before the
    first dot, is one of `FORBIDDEN`, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finite(x):
    """x with non-finite numbers as null, for a strict JSON line."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from .harness import run_cell
    from .spec import load_cell

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one", file=sys.stderr)
        return 2
    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"cannot load workload {args.workload!r}: {e}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} asks for {cell.chips} cards; {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = loaded_forbidden()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
