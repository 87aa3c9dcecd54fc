"""Calibrate gather and sort costs on the card (`tools/gather_cost_probe.py`).

    python -m gimmvfi_tpu_torch.tools.gather_cost_probe

Card only: without CUDA `main` raises. It measures what the JAX probe
measures, at its shapes and index recipes (draws from numpy with a seed):
  - `torch.gather` of whole rows at 941,056 rows (~720p pixels), widths
    8 / 32 / 128 float32, random and near-diagonal (+-64) row indices;
    width 8 bfloat16;
  - `torch.sort` of int32 keys carrying an int32 payload, 941,056 and
    5,646,336 keys;
  - the probe's three in-kernel gathers (`csrc/gather_probe.cu`) beside
    their plain versions and `torch.gather`, by CUDA events around each
    call and by the device's own time in a `torch.profiler` trace.

Layouts are the JAX probe's: (rows, lanes) float32 tables with int32 index
tables of the same shape. Indices follow `jnp.take_along_axis`: negative
ones count from the end, and one outside [-n, n) gives NaN. `subgather`,
`subgather_grid` and `lanegather` take the kernel for CUDA tensors and the
plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.kernel_build import CudaKernel
from ..utils.timing import bound_ms, cuda_ms, device_ms, fmt_ms

PIXELS = 941_056  # ~720p pixel count, the probe's p
ROWS, LANES = 512, 128  # subgather / lanegather table
BIG_ROWS = 8192  # subgather_grid table
TILE = 512  # subgather_grid's row tile


def _fill_bad(vals: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, vals, torch.full_like(vals, float("nan")))


def _normalize(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """take_along_axis's index rule: negatives count from the end; returns
    (clamped int64 index, in-range mask)."""
    v = torch.where(idx < 0, idx + n, idx).long()
    ok = (v >= 0) & (v < n)
    return v.clamp(0, n - 1), ok


def subgather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = x[idx[i, j], j]; NaN where idx is outside [-rows, rows)."""
    v, ok = _normalize(idx, x.shape[0])
    cols = torch.arange(x.shape[1], device=x.device)
    return _fill_bad(x[v, cols], ok)


def subgather_grid_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = x[(i // 512) * 512 + idx[i, j] % 512, j] (a floor mod, as
    the JAX wrapper's `idx % 512`); rows a multiple of 512."""
    rows, lanes = x.shape
    base = (torch.arange(rows, device=x.device) // TILE * TILE).view(rows, 1)
    cols = torch.arange(lanes, device=x.device)
    return x[base + torch.remainder(idx.long(), TILE), cols]


def lanegather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = x[i, idx[i, j]]; NaN where idx is outside [-lanes, lanes)."""
    v, ok = _normalize(idx, x.shape[1])
    rows = torch.arange(x.shape[0], device=x.device).view(-1, 1)
    return _fill_bad(x[rows, v], ok)


class GatherKernel(CudaKernel):
    """One of the three CUDA gathers: built at first use, with a launch counter."""

    def __init__(self, name: str, replaces: str, row_multiple: int = 1):
        super().__init__(
            name=name,
            source="gimmvfi_tpu_torch/csrc/gather_probe.cu",
            symbol=f"{name}_f32",
            argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 2,
            replaces=replaces,
        )
        self.row_multiple = row_multiple

    def __call__(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError(f"{self.name} takes a (rows, lanes) table, got {tuple(x.shape)}")
        rows, lanes = x.shape
        self.check(("x", x, torch.float32), ("idx", idx, torch.int32, x.shape, x.device))
        if rows % self.row_multiple or rows * lanes >= 2**31:
            raise ValueError(f"{self.name}: rows must be a multiple of {self.row_multiple} "
                             f"and rows * lanes < 2**31, got {tuple(x.shape)}")
        out = torch.empty_like(x)
        self.launch(x.device, x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, lanes)
        return out


SUBGATHER_KERNEL = GatherKernel("subgather", "tools/gather_cost_probe.py:87")
SUBGATHER_GRID_KERNEL = GatherKernel("subgather_grid", "tools/gather_cost_probe.py:106", TILE)
LANEGATHER_KERNEL = GatherKernel("lanegather", "tools/gather_cost_probe.py:125")


def _dispatch(kernel: GatherKernel, plain, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return kernel(x, idx)
    if x.device.type == "cpu":
        return plain(x, idx)
    raise NotImplementedError(f"no {kernel.name} for device {x.device}")


def subgather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _dispatch(SUBGATHER_KERNEL, subgather_plain, x, idx)


def subgather_grid(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _dispatch(SUBGATHER_GRID_KERNEL, subgather_grid_plain, x, idx)


def lanegather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _dispatch(LANEGATHER_KERNEL, lanegather_plain, x, idx)


# kernel name -> (kernel, plain version, torch.gather yardstick on `library_index`)
GATHERS = {
    "subgather": (SUBGATHER_KERNEL, subgather_plain,
                  lambda x, idx: torch.gather(x, 0, idx)),
    "subgather_grid": (SUBGATHER_GRID_KERNEL, subgather_grid_plain,
                       lambda x, idx: torch.gather(x.view(-1, TILE, x.shape[1]), 1,
                                                   idx.view(-1, TILE, x.shape[1]))),
    "lanegather": (LANEGATHER_KERNEL, lanegather_plain,
                   lambda x, idx: torch.gather(x, 1, idx)),
}


def gather_tables(seed=0) -> dict:
    """The JAX probe's tables and index recipes (`gather_cost_probe.py:79-123`)
    as numpy arrays, keyed by kernel name: (x float32, idx int32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, LANES), dtype=np.float32)
    idx = rng.integers(0, ROWS, (ROWS, LANES), dtype=np.int32)
    xb = rng.standard_normal((BIG_ROWS, LANES), dtype=np.float32)
    idxb = rng.integers(0, 8, (BIG_ROWS, LANES), dtype=np.int32) + (
        np.arange(BIG_ROWS, dtype=np.int32)[:, None] // 8 * 8
    ) % BIG_ROWS
    idxl = rng.integers(0, LANES, (ROWS, LANES), dtype=np.int32)
    return {"subgather": (x, idx), "subgather_grid": (xb, idxb), "lanegather": (x, idxl)}


def library_index(name: str, idx: torch.Tensor) -> torch.Tensor:
    """The index `torch.gather` takes for kernel `name` (int64; the grid's
    `% 512` applied), made outside any timed region."""
    return torch.remainder(idx, TILE).long() if name == "subgather_grid" else idx.long()


def gather_bound(x: torch.Tensor) -> tuple[float, str]:
    """x, idx and out once each: 12 bytes an element."""
    return bound_ms(3 * 4 * x.numel())


def measure_kernels(seed=0, iters=20) -> dict:
    """Each gather kernel, its plain version and torch.gather at the probe's
    shapes on the card (median ms of `iters` after one warm-up, CUDA events),
    and the kernel's and torch.gather's own device time from a
    `torch.profiler` trace (`device_ms`, `library_device_ms`; None where the
    trace shows none); prints each."""
    res = {}
    for name, (xn, idxn) in gather_tables(seed).items():
        kernel, plain, library = GATHERS[name]
        x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idxn).cuda()
        idx64 = library_index(name, idx)
        row = {
            "ms": cuda_ms(lambda: kernel(x, idx), iters=iters),
            "plain_ms": cuda_ms(lambda: plain(x, idx), iters=iters),
            "library_ms": cuda_ms(lambda: library(x, idx64), iters=iters),
        }
        row["device_ms"] = device_ms(lambda: kernel(x, idx))[0]
        row["library_device_ms"] = device_ms(lambda: library(x, idx64))[0]
        row["bound_ms"], row["bound_by"] = gather_bound(x)
        res[name] = row
        print(f"{name} {tuple(x.shape)}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"torch.gather {row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms; "
              f"device time from the profiler: kernel {fmt_ms(row['device_ms'], 6)}, "
              f"torch.gather {fmt_ms(row['library_device_ms'], 6)}", flush=True)
    return res


def library_table(seed=0, iters=20) -> list[tuple[str, float]]:
    """torch.gather by width and index locality, and torch.sort, at the
    probe's sizes on the card; prints and returns (label, median ms)."""
    rng = np.random.default_rng(seed)
    p = PIXELS
    idx_rand = torch.from_numpy(rng.integers(0, p, (1, p))).cuda()
    idx_near = torch.from_numpy(
        np.clip(np.arange(p)[None] + rng.integers(-64, 64, (1, p)), 0, p - 1)
    ).cuda()
    rows = []

    def take(label, src, idx):
        index = idx.view(1, p, 1).expand(1, p, src.shape[2])
        ms = cuda_ms(lambda: torch.gather(src, 1, index), iters=iters)
        rows.append((label, ms))
        print(f"{label:58s} {ms:9.4f} ms  {ms / p * 1e6:.3f} ns/row", flush=True)

    for width in (8, 32, 128):
        src = torch.from_numpy(rng.standard_normal((1, p, width), dtype=np.float32)).cuda()
        take(f"torch.gather random idx, {width} lanes f32", src, idx_rand)
        take(f"torch.gather near-diag idx, {width} lanes f32", src, idx_near)
    src8 = torch.from_numpy(rng.standard_normal((1, p, 8), dtype=np.float32)).cuda()
    take("torch.gather random idx, 8 lanes bf16", src8.bfloat16(), idx_rand)

    for n in (p, 6 * p):
        keys = torch.from_numpy(rng.integers(0, n, n, dtype=np.int32)).cuda()
        payload = torch.arange(n, dtype=torch.int32, device="cuda")

        def sort_key_val():
            sorted_keys, order = torch.sort(keys)
            return sorted_keys, payload[order]

        ms = cuda_ms(sort_key_val, iters=iters)
        rows.append((f"torch.sort int32 keys + int32 payload n={n}", ms))
        print(f"{rows[-1][0]:58s} {ms:9.4f} ms", flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    print(torch.cuda.get_device_name(0), flush=True)
    return library_table(), measure_kernels()


if __name__ == "__main__":
    main()
