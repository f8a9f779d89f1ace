"""Build the port's CUDA sources and bind their C entry points with ctypes.

Each `rfx_torch/csrc/<name>.cu` compiles on first use, with `nvcc` alone and
no PyTorch headers, into `build/rfx_torch/<name>-<hash>.so` at the root of the
checkout; the hash covers every file in `csrc/` and the flags, so an edited
source builds anew and an unchanged one loads what is there. Flags:

- `-gencode arch=compute_90a,code=sm_90a`: Hopper (H100);
- `-fmad=false`: no multiply-add contraction, so the kernels round every
  product and sum as PyTorch's elementwise operations do in the plain
  versions they are checked against;
- no `--use_fast_math`: division and sqrt stay IEEE.

A C entry takes its pointers and the stream as `void*`, launches on the
stream it is given, allocates nothing, and returns `cudaGetLastError()`;
`CudaKernel.launch` raises if that is not 0 and counts the launch otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rfx_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas=-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC_DIR.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(source: str) -> tuple[Path, str]:
    """Compile `csrc/<source>` unless its library exists; returns the library
    path and the compiler's output (ptxas register and spill report)."""
    src = CSRC_DIR / source
    out = BUILD_DIR / f"{src.stem}-{_sources_digest()}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Two kernels of one source may build at once from two threads: each
    # writes its own file, and the rename is atomic.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


class CudaKernel:
    """One C entry point of a `csrc/*.cu` file and its launch count.

    `launches` goes up by one each time `launch` runs the entry without an
    error, and nowhere else; a caller may reset it to 0 to count one run."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the entry point; returns it."""
        if self._fn is None:
            path, self.build_log = build(self.source)
            self._lib = ctypes.CDLL(str(path))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def symbol_of(self, name: str):
        """Another entry point of the same library (after `load`)."""
        self.load()
        return getattr(self._lib, name)

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            describe = self.symbol_of(f"{self.symbol}_error_string")
            describe.argtypes = [ctypes.c_int]
            describe.restype = ctypes.c_char_p
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {describe(err).decode()}")
        self.launches += 1
