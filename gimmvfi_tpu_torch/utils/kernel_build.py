"""Build a CUDA source of `csrc/` into a shared library and load it with ctypes.

The library has a plain C interface, so `nvcc` compiles it in seconds (no
PyTorch headers). Builds go to `build/kernels/` at the repository root,
keyed by a hash of the source and the flags, so a fresh checkout builds
each kernel once at first use. A missing `nvcc` or a failed build raises
with the compiler's output.

`CudaKernel` is the wrapper base every kernel shares: it binds one
`extern "C"` launcher, builds its library at first use, launches on the
current stream of the tensors' device, raises on a non-zero `cudaError`
and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

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


def library_path(source_name: str) -> Path:
    """Where `csrc/<source_name>` builds to, keyed by its text and the flags."""
    src = CSRC / source_name
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{key}.so"


def build_library(source_name: str) -> tuple[ctypes.CDLL, str]:
    """Compile `csrc/<source_name>` (cached) and return (library, ptxas log).

    The log is empty when the library came from the cache.
    """
    src = CSRC / source_name
    lib_path = library_path(source_name)
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
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


def substitute(src: str, subs, what: str) -> str:
    """`src` with each (old, new) of `subs` replaced in turn; each `old`
    must occur exactly once, or it raises naming `what`."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{what}: {old!r} occurs {src.count(old)} times in the source")
        src = src.replace(old, new)
    return src


def build_text(name: str, text: str) -> tuple[ctypes.CDLL, str]:
    """Build CUDA source `text` (a kernel's variant, or a measurement
    fixture) as `build/kernels/ablate/<name>.cu` with the kernels' nvcc
    flags; returns (library, ptxas log). A failed build raises."""
    out_dir = BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib_path = out_dir / f"{name}.so"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(lib_path)), proc.stdout + proc.stderr


def build_libraries(source_names) -> dict[str, str]:
    """Compile several `csrc/` sources at once, one `nvcc` each; returns
    {source name: ptxas log}. Any failed build raises."""
    names = sorted(set(source_names))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        logs = list(pool.map(lambda name: build_library(name)[1], names))
    return dict(zip(names, logs))


class CudaKernel:
    """One `extern "C"` launcher of a `csrc/` library, bound with ctypes.

    The launcher takes `argtypes` followed by the stream and returns
    `cudaGetLastError()` as an int. `launches` moves only in `launch`.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = source  # path in the repository, e.g. gimmvfi_tpu_torch/csrc/x.cu
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.replaces = replaces  # file:line of the TPU kernel
        self.launches = 0
        self._fn = None

    def build(self) -> str:
        """Build (or load from the cache) the library; returns the ptxas log."""
        lib, log = build_library(Path(self.source).name)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return log

    def launch(self, device: torch.device, *args) -> None:
        """Run the launcher on `device`'s current stream; raise on a launch error."""
        if self._fn is None:
            self.build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1

    def check(self, *specs) -> None:
        """Raise unless every spec `(what, tensor, dtype[, shape[, device]])`
        names a contiguous, 16-byte aligned CUDA tensor of `dtype` (and of
        `shape` on `device`, where given). Whether the tensors lie on a CUDA
        device is checked last, so CPU tensors show every other fault first."""
        for what, t, dtype, *where in specs:
            shape, device = (where + [None, None])[:2]
            if t.dtype != dtype:
                raise TypeError(f"{self.name}: {what} must be {dtype}, got {t.dtype}")
            if shape is not None and tuple(t.shape) != tuple(shape):
                raise ValueError(f"{self.name}: {what} must have shape {tuple(shape)}, "
                                 f"got {tuple(t.shape)}")
            if device is not None and t.device != device:
                raise ValueError(f"{self.name}: {what} is on {t.device}, expected {device}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{self.name}: {what} must be contiguous and 16-byte aligned")
        for what, t, *_ in specs:
            if not t.is_cuda:
                raise ValueError(f"{self.name}: {what} must be a CUDA tensor, got {t.device}")
