"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, and loaded with `ctypes`.  Nothing includes PyTorch's
headers, so a build takes seconds.  The build happens at first use, from
the sources in the checkout, into `_build/` beside this file (listed in
`.gitignore`); a library is named by a hash of its source and flags, so a
changed source rebuilds and an unchanged one is reused.

Each kernel is a `Kernel` object, declared in `KERNELS` below, holding its
library and an integer `launches` that its wrapper increments once per
launch and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH; raises when there is none."""
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(Path(os.environ[env]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from uptune_tpu_torch/"
        "csrc at first use on a machine with the CUDA toolkit")


class Kernel:
    """One hand-written kernel: its source, C symbol and signature, the
    loaded library, and the count of launches."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}.{h.hexdigest()[:16]}.so"

    def function(self):
        """The kernel's C launcher, building the library if needed."""
        if self._fn is None:
            build([self])
            fn = getattr(ctypes.CDLL(str(self.library_path())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


# Every kernel of the port.  merge_rows(hist_h0, hist_h1, hist_q, hist_age,
# new_h0, new_h1, new_q, new_age, pos_new, out_h0, out_h1, out_q, out_age,
# cap, b, stream); its wrapper is `ops/dedup.py::merge_rows_cuda`.
MERGE = Kernel(
    name="merge_rows", source="merge.cu", symbol="ut_merge_rows",
    argtypes=[ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p],
    replaces="uptune_tpu/ops/dedup.py:99")   # _merge_kernel
KERNELS = (MERGE,)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def build(todo: Optional[Sequence[Kernel]] = None) -> Dict[str, Path]:
    """Compile the kernels whose library is missing, one `nvcc` per
    source.  Returns {name: library path}; raises with the compiler's
    output if a build fails."""
    todo = KERNELS if todo is None else todo
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for k in todo:
        out = k.library_path()
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(k.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        k.build_log = proc.stdout
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"kernel build failed: {k.source.name}: nvcc "
                               f"exit {proc.returncode}\n{proc.stdout}")
        os.replace(tmp, out)
    return {k.name: k.library_path() for k in todo}


def check(err: int, kernel: Kernel) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel.name} ({kernel.source.name}) failed to "
            f"launch: cudaError_t {err}")
