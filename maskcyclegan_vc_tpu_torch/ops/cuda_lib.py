"""Build and bind the port's CUDA kernels: nvcc into a shared library, ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers, so it
compiles in seconds) and builds on its own, for ``sm_90a``, into
``build/kernels/<name>-<digest>.so`` beside the package. The digest covers
the source and the flags, so an edited source builds anew and an unchanged
one loads what an earlier process built. Nothing is built at import: a
library builds at its first launch, or earlier through ``build``.

Every C entry point returns a ``cudaError_t`` from ``cudaGetLastError()``
right after its launch; ``CudaKernel`` raises if it is not 0, so a launch the
card refused never passes silently. A fault during the kernel's run shows at
the next synchronisation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR = ctypes.c_void_p
INT = ctypes.c_int

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, named by a digest of its inputs."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source not built yet, one nvcc each, all at once.

    Returns each new build's compiler output (``-Xptxas -v`` reports the
    registers, shared memory and spills of every kernel). Raises with the
    output of any build that failed.
    """
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w+")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out)
    logs, failed = {}, []
    for name, (proc, log, tmp, out) in procs.items():
        proc.wait()
        with log:
            log.seek(0)
            logs[name] = log.read()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [INT]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` goes up by one for each launch that the card accepted;
    a caller may set it back to 0 to count the launches of one run.
    """

    def __init__(self, library: str, symbol: str, argtypes: Sequence):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = INT
            self._fn = fn
        code = self._fn(*args)
        if code != 0:
            msg = load(self.library).kernel_error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code} ({msg})")
        self.launches += 1
