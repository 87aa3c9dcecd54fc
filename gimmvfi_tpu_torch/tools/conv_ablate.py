"""What bounds the 3x3-conv kernel: variants of `csrc/conv3x3.cu` with one
part taken out, timed beside the kernel and cuDNN in one process.

    python -m gimmvfi_tpu_torch.tools.conv_ablate

Card only: without CUDA `main` raises. Each variant is the kernel's source
with a few text substitutions, built with the same nvcc flags into
`build/kernels/ablate/`:
  - kernel: the source as it is;
  - stages3: a ring of 3 stages instead of 4;
  - no_epilogue: the epilogue cut to a sum of the accumulators, which keeps
    the products alive and stores nothing;
  - no_loads: after its first tile a block issues no TMA loads; the
    producer arrives on the full barrier itself and the consumers multiply
    what the stage already holds;
  - no_loads_no_epilogue: both.
Only `kernel` and `stages3` compute the conv; they are checked against the
plain version. At the probe shape (1,736,1280,256)x(3,3,256,256) bf16 each
variant and cuDNN channels-last are timed by their own device time from a
`torch.profiler` trace, twice, in opposite orders. The gap between a
variant and `kernel` is what the part taken out costs.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils.kernel_build import CSRC, build_text, substitute
from ..utils.timing import device_ms
from .conv_proto import (
    conv3x3_library,
    conv3x3_plain,
    kernel_weights,
    library_operands,
    probe_inputs,
)

_KEEP_ALIVE = """      {  // keep the products alive without storing them
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 128; ++i) sum += d[i];
        if (sum == 1.2345e-38f) out_row[tid] = __float2bfloat16(sum);
      }
"""
_OUT_ROW = "      __nv_bfloat16* out_row = out + (size_t)tl.row * wd * cout;\n"
NO_EPILOGUE = [
    (_OUT_ROW, _OUT_ROW + _KEEP_ALIVE),
    ("for (int j = 0; j < kBN / 64; ++j) {", "for (int j = 0; j < 0; ++j) {"),
]
NO_LOADS = [
    ("mbar_expect_tx(full + 8 * stage, kStageBytes);",
     "const bool first = t == (int)blockIdx.x;\n"
     "          if (first) mbar_expect_tx(full + 8 * stage, kStageBytes);\n"
     "          else mbar_arrive(full + 8 * stage);"),
    ("tma_load_4d(a_smem", "if (first) tma_load_4d(a_smem"),
    ("tma_load_3d(b_smem", "if (first) tma_load_3d(b_smem"),
]
# variant name -> (substitutions, whether it still computes the conv)
VARIANTS = {
    "kernel": ([], True),
    "stages3": ([("constexpr int kStages = 4;", "constexpr int kStages = 3;")], True),
    "no_epilogue": (NO_EPILOGUE, False),
    "no_loads": (NO_LOADS, False),
    "no_loads_no_epilogue": (NO_LOADS + NO_EPILOGUE, False),
}


def variant_source(name: str, src: str) -> str:
    """`src` with variant `name`'s substitutions; each must match exactly once."""
    return substitute(src, VARIANTS[name][0], f"variant {name}")


def build_variant(name: str):
    """Build variant `name` into build/kernels/ablate/ and bind its launcher."""
    lib, _ = build_text(f"conv3x3_{name}", variant_source(name, (CSRC / "conv3x3.cu").read_text()))
    fn = lib.conv3x3_bf16
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(iters=20):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    x, w = probe_inputs()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    wt = kernel_weights(w)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    ref = conv3x3_plain(x, w).float()

    def runner(fn):
        def run():
            err = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"conv3x3_bf16 launch failed: error {err}")
        return run

    calls = {name: runner(fn) for name, fn in fns.items()}
    for name, (_, computes) in VARIANTS.items():
        if computes:
            calls[name]()
            diff = float((out.float() - ref).abs().max())
            print(f"{name}: max diff vs plain {diff:.3e}", flush=True)
            if not diff <= 2.0**-6 * float(ref.abs().max()):
                raise AssertionError(f"variant {name} disagrees with the plain version")
    nhwc = library_operands(x, w, channels_last=True)
    calls["cudnn_channels_last"] = lambda: conv3x3_library(*nhwc)
    res = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            res[name].append(device_ms(calls[name], iters=iters)[0])
    for name, times in res.items():
        print(f"conv3x3 {tuple(x.shape)} {name:22s} device time "
              f"{' / '.join(f'{t:.4f}' for t in times)} ms; {smi}", flush=True)
    return res


if __name__ == "__main__":
    main()
