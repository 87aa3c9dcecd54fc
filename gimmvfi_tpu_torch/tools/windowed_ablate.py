"""The windowed-correlation kernel's inputs, its check on the card, and its
ablations.

    python -m gimmvfi_tpu_torch.tools.windowed_ablate

Card only: without CUDA `main` raises. Each variant is
`csrc/windowed_corr.cu` with text substitutions, built with the same nvcc
flags into `build/kernels/ablate/`. The design's steps, each variant with
the steps before it and none after:
  - first: one query's levels inside the block's query loop, one FMA chain
    over a lane's chunks, no unroll of the tap loop, no minimum of blocks
    an SM in `__launch_bounds__`, the output staging in rows of 32 queries;
  - levels_outer: the block sweeps one level at a time over its queries,
    so its warps read neighbouring windows of one map together;
  - chains: one FMA chain a chunk, so the chunks' FMAs overlap;
  - unroll2: the tap loop unrolled twice;
  - blocks3: `__launch_bounds__` asks for 3 blocks an SM (<= 85 registers);
  - kernel: the source as it is, whose staging rows hold 33 queries, so
    that a warp's blend writes (one query, 32 rows) fall in 32 banks.
And three ablations of `kernel`, which do not compute the lookup and are
not checked:
  - no_f2_loads: the window's pixels are not read; each tap dots f1 with
    itself (the FMAs and everything else stay);
  - no_fmas: the window's pixels are read with the same 16-byte loads and
    folded with one xor a load instead of 8 FMAs (bf16: every byte is read;
    float32 reads half of each chunk);
  - skeleton: neither: the tap loop's bounds checks, shuffles, blend and
    stores.
Every variant that computes the lookup is checked against
`windowed_corr_lookup_plain` in `WINDOWED_CASES` and at `AMT_2K`; then each
variant is timed by its own device time from a `torch.profiler` trace, at
`RAFT_2K` and `RAFT_720P` in bf16, twice, in opposite orders.

`WINDOWED_CASES`, the lookup shapes, `windowed_inputs` and
`windowed_agreement` are shared with `chip_smoke.py` phase 7.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import corr as corr_ops
from ..ops.corr import WindowedCorrKernel, windowed_corr_lookup_plain
from ..utils.kernel_build import CSRC, build_text, substitute
from ..utils.timing import bound_ms, device_ms

# (C, dtype, coordinate kind, radius, levels, (N, h, w)): the path's C at
# two sizes; a small C on an odd size (13x23 pools to 6x11, 3x5, 1x2);
# other radii and level counts
WINDOWED_CASES = [
    (256, torch.float32, "in_frame", 4, 4, (2, 40, 48)),
    (256, torch.bfloat16, "in_frame", 4, 4, (2, 40, 48)),
    (256, torch.float32, "border", 4, 4, (1, 36, 64)),
    (256, torch.bfloat16, "far", 4, 4, (1, 36, 64)),
    (24, torch.float32, "border", 4, 4, (2, 13, 23)),
    (24, torch.bfloat16, "far", 4, 4, (2, 13, 23)),
    (16, torch.float32, "in_frame", 4, 4, (1, 13, 23)),
    (64, torch.float32, "far", 3, 2, (1, 9, 15)),
    (8, torch.bfloat16, "border", 1, 1, (2, 7, 9)),
]
# the lookups of the 2048x1088 DS 1.0 path (C = 256, bf16, 4 levels, r = 4):
# RAFT's, both directions batched, and the AMT's, one a direction; and
# RAFT's at the 720p fmap
RAFT_2K = (2, 136, 256)
AMT_2K = (1, 136, 256)
RAFT_720P = (2, 92, 160)

_LEVELS_OUTER = """  for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
    for (int lq = warp; lq < kQueries; lq += kWarps) {
"""
_LEVELS_INNER = """  for (int lq = warp; lq < kQueries; lq += kWarps) {
    for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
"""
_CHAINS = """          float part[kMaxChunks];
#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
            part[k] = a[k][0] * b[k][0];
#pragma unroll
            for (int j = 1; j < 8; ++j) part[k] = fmaf(a[k][j], b[k][j], part[k]);
          }
          acc = (part[0] + part[1]) + (part[2] + part[3]);
"""
_ONE_CHAIN = """#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc = fmaf(a[k][j], b[k][j], acc);
          }
"""
_F2_LOAD = "load8(px + ch * 8, b[k]);"
_B_DECL = "float b[kMaxChunks][8];"
# the design's steps, last first: (the variant that ends with the step, the
# substitutions that undo it)
STEPS = [
    ("kernel", [("s_out[kMaxLevels * kMaxWin * kMaxWin][kQueries + 1]",
                 "s_out[kMaxLevels * kMaxWin * kMaxWin][kQueries]")]),
    ("blocks3", [("constexpr int kBlocksPerSM = 3;", "constexpr int kBlocksPerSM = 1;")]),
    ("unroll2", [("#pragma unroll 2\n", "#pragma unroll 1\n")]),
    ("chains", [(_CHAINS, _ONE_CHAIN)]),
    ("levels_outer", [(_LEVELS_OUTER, _LEVELS_INNER)]),
]
ABLATIONS = {
    "no_f2_loads": [(_F2_LOAD, "for (int j = 0; j < 8; ++j) b[k][j] = a[k][j];")],
    "no_fmas": [
        (_B_DECL, _B_DECL + "\n          uint32_t bits = 0u;"),
        (_F2_LOAD, "const uint4 u = __ldg(reinterpret_cast<const uint4*>(px + ch * 8));\n"
                   "              bits ^= u.x ^ u.y ^ u.z ^ u.w;"),
        (_CHAINS, "          acc = __uint_as_float(bits & 0x007fffffu);\n"),
    ],
    "skeleton": [(_F2_LOAD, "b[k][0] = 0.0f;"), (_CHAINS, "          acc = (float)(x + y);\n")],
}


def _variants() -> dict[str, tuple[list, bool]]:
    """variant name -> (substitutions into the kernel's source, whether it
    computes the lookup): `first`, then each step in the design's order
    (a step's variant undoes the steps after it), then the ablations."""
    out = {"first": ([sub for _, subs in STEPS for sub in subs], True)}
    for i in reversed(range(len(STEPS))):
        out[STEPS[i][0]] = ([sub for _, subs in STEPS[:i] for sub in subs], True)
    out.update({name: (subs, False) for name, subs in ABLATIONS.items()})
    return out


VARIANTS = _variants()


def variant_source(name: str, src: str) -> str:
    """`src` with variant `name`'s substitutions; each must match exactly once."""
    return substitute(src, VARIANTS[name][0], f"variant {name}")


def windowed_inputs(shape, c, dtype, kind, levels=4, seed=0, device="cuda"):
    """A windowed state from seeded NCHW maps and (N, 2, h, w) coordinates:
    in the frame (the grid plus N(0, 3 px)), around its border, or far off
    it (1e3 and 1e10 px, NaN and inf). Returns (state, coords, (f1, f2))."""
    n, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    f1, f2 = (torch.randn((n, c, h, w), generator=gen).to(dtype) for _ in range(2))
    grid = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(h), indexing="xy")).float()
    if kind == "in_frame":
        coords = grid + 3.0 * torch.randn((n, 2, h, w), generator=gen)
    elif kind == "border":
        edge = torch.tensor([-4.5, -1.25, -0.5, 0.0, 0.75])[
            torch.randint(5, (n, 2, h, w), generator=gen)]
        far = torch.rand((n, 2, h, w), generator=gen) < 0.5
        coords = torch.where(far, torch.tensor([w, h]).view(1, 2, 1, 1) - 1 - edge, edge)
    elif kind == "far":
        coords = torch.tensor([-1e3, 1e3, -1e10, 1e10, 3.5])[
            torch.randint(5, (n, 2, h, w), generator=gen)]
        bad = torch.rand((n, 2, h, w), generator=gen) < 0.1
        coords[bad] = torch.tensor([float("nan"), float("inf"), -float("inf")])[
            torch.randint(3, (int(bad.sum()),), generator=gen)]
    else:
        raise ValueError(f"unknown coordinate kind {kind!r}")
    f1, f2 = f1.to(device), f2.to(device)
    wc = corr_ops.windowed_corr_pyramid(f1, f2, levels)
    return wc, coords.float().to(device), (f1, f2)


def windowed_agreement(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The kernel's tolerance against the plain version, in the output's
    dtype: float32 within 1e-5 of the largest value (sums in another
    order); bf16 within one bf16 step, 2**-7 |plain| + 1e-6 max|plain| (the
    two float32 sums may round either way); NaN at the same places.
    Returns the max-abs error, the largest |plain|, the elements over the
    bound, the NaN count and whether they agree."""
    bf16 = ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    nan = torch.isnan(ref)
    err = (got[~nan] - ref[~nan]).abs()
    scale = float(ref[~nan].abs().max()) if err.numel() else 0.0
    limit = 2.0**-7 * ref[~nan].abs() + 1e-6 * scale if bf16 else 1e-5 * scale
    bad = int((err > limit).sum())
    same_nan = torch.equal(torch.isnan(got), nan)
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0, "scale": scale,
            "bad": bad, "nan": int(nan.sum()), "ok": bad == 0 and same_nan}


def bind(name: str, text: str) -> tuple[WindowedCorrKernel, str]:
    """Build a source with the kernel's launcher; returns a wrapper that
    launches it (with launch counts of its own) and the ptxas lines."""
    lib, log = build_text(f"windowed_corr_{name}", text)
    kernel = WindowedCorrKernel()
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    keep = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return kernel, " | ".join(keep)


def main(iters=10):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src = (CSRC / "windowed_corr.cu").read_text()
    texts = {name: variant_source(name, src) for name in VARIANTS}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda name: bind(name, texts[name]), texts)))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {log}", flush=True)

    checks = [(shape, c, dtype, kind, radius, levels)
              for c, dtype, kind, radius, levels, shape in WINDOWED_CASES]
    checks.append((AMT_2K, 256, torch.bfloat16, "in_frame", 4, 4))
    for i, (shape, c, dtype, kind, radius, levels) in enumerate(checks):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=i)
        ref = windowed_corr_lookup_plain(wc, coords, radius)
        for name, (kernel, _) in built.items():
            if VARIANTS[name][1]:
                agree = windowed_agreement(kernel(wc, coords, radius), ref)
                if not agree["ok"]:
                    raise AssertionError(f"variant {name} disagrees with the plain version at "
                                         f"{shape} C={c} {dtype} {kind}: {agree}")
        del wc, coords, ref
    print(f"every variant that computes the lookup agrees with the plain version in all "
          f"{len(checks)} cases", flush=True)

    res = {}
    for label, shape in (("2048x1088 DS 1.0 RAFT", RAFT_2K), ("720p RAFT", RAFT_720P)):
        wc, coords, _ = windowed_inputs(shape, 256, torch.bfloat16, "in_frame")
        bound, bound_by = bound_ms(*corr_ops.windowed_corr_work(wc, coords))
        calls = {name: (lambda k=kernel: k(wc, coords)) for name, (kernel, _) in built.items()}
        times = {name: [] for name in calls}
        for order in (list(calls), list(reversed(calls))):
            for name in order:
                _, by_name = device_ms(calls[name], iters=iters)
                times[name].append(sum(v for k, v in by_name.items() if "windowed_corr" in k))
        for name, turns in times.items():
            print(f"windowed_corr {label} {shape} C=256 bf16 {name:13s} device "
                  f"{' / '.join(f'{t:.4f}' for t in turns)} ms "
                  f"({' / '.join(f'{100 * bound / t:.1f}' for t in turns)}% of the "
                  f"{bound:.4f} ms {bound_by} bound); {smi}", flush=True)
        res[label] = times
        del wc, coords
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    main()
