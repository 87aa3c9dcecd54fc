"""Build a CUDA source of `csrc/` into a shared library and load it with ctypes.

The library has a plain C interface, so `nvcc` compiles it in seconds (no
PyTorch headers). Builds go to `build/kernels/` at the repository root,
keyed by a hash of the source and the flags, so a fresh checkout builds
each kernel once at first use. A missing `nvcc` or a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found on PATH or under {cuda_home}/bin: "
        "the CUDA kernels are built from source at first use"
    )


def build_library(source_name: str) -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source_name>` (cached) and return (library, ptxas log).

    The log is empty when the library came from the cache.
    """
    src = CSRC / source_name
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{src.stem}-{key}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        log = proc.stdout + proc.stderr
    return ctypes.CDLL(str(lib_path)), log
