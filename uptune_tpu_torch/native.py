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
launch and nowhere else.  Several launchers may share one source (and so
one library): `csrc/gp_tile.cu` holds four.
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
    """One hand-written kernel's launcher: its source, C symbol and
    signature, the TPU kernels it replaces, the loaded library, and the
    count of launches."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: Sequence[str],
                 limit: Optional[str] = None):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = tuple(replaces)     # "path:line" of each TPU kernel
        # the library's query of the largest N it takes, (f, var) -> int
        self.limit = limit
        self.launches = 0
        self._lib = None
        self._fn = None

    def library_path(self) -> Path:
        return library_path(self.source)

    @property
    def build_log(self) -> str:
        """nvcc's output (with ptxas's registers and shared memory) for
        this kernel's library, read back from beside the library, so a
        reused library reports it as a fresh build does."""
        log = log_path(self.library_path())
        return log.read_text() if log.exists() else ""

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._lib is None:
            build([self])
            self._lib = ctypes.CDLL(str(self.library_path()))
        return self._lib

    def function(self):
        """The kernel's C launcher, building the library if needed."""
        if self._fn is None:
            fn = getattr(self.library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def query(self, symbol: str, *args: int, restype=ctypes.c_int) -> int:
        """Call a host-only C function of the library that takes ints and
        returns an integer of `restype` (a launch-geometry limit or a
        scratch size the wrapper reads)."""
        fn = getattr(self.library(), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = restype
        return int(fn(*args))


def library_path(source: Path) -> Path:
    """The library built from `source`: named by a hash of the source and
    the flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}.{h.hexdigest()[:16]}.so"


def log_path(lib: Path) -> Path:
    return lib.with_suffix(".log")


_P, _I = ctypes.c_void_p, ctypes.c_int

# Every kernel of the port.  merge_rows(hist_h0, hist_h1, hist_q, hist_age,
# new_h0, new_h1, new_q, new_age, pos_new, out_h0, out_h1, out_q, out_age,
# n, cap, b, stream): n instances' [n, cap] histories and [n, b] batches in
# one launch; its wrapper is `ops/dedup.py::merge_rows_cuda`.  A block
# finds its own window of pos_new with a warp's multiway search and marks
# it in shared memory; any b is taken.
MERGE = Kernel(
    name="merge_rows", source="merge.cu", symbol="ut_merge_rows",
    argtypes=[_P] * 13 + [_I, _I, _I, _P],
    replaces=("uptune_tpu/ops/dedup.py:99",))           # _merge_kernel
# The four launchers of csrc/gp_tile.cu; wrappers in
# surrogate/pallas_score.py (A, B) and ops/acquire.py (C, D).
# Their launch geometry lives in the .cu file alone; the wrappers read
# it through `Kernel.query`: the largest N (`limit`, by features and
# kind), for B, C and D the scratch size (ut_acquire_scratch_words) and
# D's candidate count (ut_acquire_topk_slots).
# A: ut_gp_mean(qc, qk, xc, xk, alpha, mu, b, n, fc, fk, stream); one
#    kernel, gp_mean_kernel: the distances' cross term on the tensor cores
#    in 3xTF32, the Matérn epilogue in registers, N split over a cluster
GP_MEAN = Kernel(
    name="gp_mean", source="gp_tile.cu", symbol="ut_gp_mean",
    argtypes=[_P] * 6 + [_I] * 4 + [_P],
    replaces=("uptune_tpu/surrogate/pallas_score.py:66",    # _score_kernel
              "uptune_tpu/surrogate/pallas_score.py:77",    # _mixed
              "uptune_tpu/surrogate/pallas_score.py:89"),   # _expham
    limit="ut_gp_max_train_rows")
# B: ut_gp_mean_var(qc, qk, xc, xk, alpha, kinv, mu, q, scratch, b, n, fc,
#    fk, stream); C's passes kinv_prep, krows and wq (k K^-1 on the tensor
#    cores in 3xTF32), then moments (mu_n and q themselves)
GP_MEAN_VAR = Kernel(
    name="gp_mean_var", source="gp_tile.cu", symbol="ut_gp_mean_var",
    argtypes=[_P] * 9 + [_I] * 4 + [_P],
    replaces=("uptune_tpu/surrogate/pallas_score.py:107",   # _var_kernel
              "uptune_tpu/surrogate/pallas_score.py:112",   # _mixed
              "uptune_tpu/surrogate/pallas_score.py:119"),  # _expham
    limit="ut_acquire_max_train_rows")
# C: ut_acquire_scores(qc, qk, xc, xk, alpha, kinv, params, u, scratch, b,
#    n, fc, fk, kind, stream); passes kinv_prep (K^-T), krows (k, mean),
#    wq (k K^-1 on the tensor cores in 3xTF32, q) and final (utility)
ACQ_SCORES = Kernel(
    name="acquire_scores", source="gp_tile.cu", symbol="ut_acquire_scores",
    argtypes=[_P] * 9 + [_I] * 5 + [_P],
    replaces=("uptune_tpu/ops/acquire.py:151",),        # _scores_kernel
    limit="ut_acquire_max_train_rows")
# D: ut_acquire_topk(qc, qk, xc, xk, alpha, kinv, params, u, vals, idx,
#    scratch, b, n, fc, fk, kind, k, stream); C's passes with a per-chunk
#    sort in the final pass, then topk_merge (ranks across chunks)
ACQ_TOPK = Kernel(
    name="acquire_topk", source="gp_tile.cu", symbol="ut_acquire_topk",
    argtypes=[_P] * 11 + [_I] * 6 + [_P],
    replaces=("uptune_tpu/ops/acquire.py:157",),        # _topk_kernel
    limit="ut_acquire_max_train_rows")
KERNELS = (MERGE, GP_MEAN, GP_MEAN_VAR, ACQ_SCORES, ACQ_TOPK)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def build(todo: Optional[Sequence[Kernel]] = None) -> Dict[str, Path]:
    """Compile the libraries that are missing, one `nvcc` per source, all
    started together.  nvcc's output is kept beside each library
    (`<library>.log`); a library without its log counts as missing, so
    every library's registers and shared memory can be read back.
    Returns {kernel name: library path}; raises with the compiler's
    output if a build fails."""
    todo = KERNELS if todo is None else todo
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {k.library_path(): k.source for k in todo}
    running = []
    for out, src in sources.items():
        if out.exists() and log_path(out).exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((out, src, tmp, proc))
    failed = []
    for out, src, tmp, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n{text}")
            continue
        log_path(out).write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {k.name: k.library_path() for k in todo}


def check(err: int, kernel: Kernel) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel.name} ({kernel.source.name}) failed to "
            f"launch: cudaError_t {err}")
