"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, and loaded with `ctypes`.  Nothing includes PyTorch's
headers, so a build takes seconds.  The build happens at first use, from
the sources in the checkout, into `_build/` beside this file (listed in
`.gitignore`); a library is named by a hash of its source and flags, so a
changed source rebuilds and an unchanged one is reused.

Each kernel is a `Kernel` object, declared in `KERNELS` below, which its
wrapper launches through `Kernel.launch` alone: the one place that calls
the C function and counts (`counts()` reads every counter as one record).
Launchers B, C and D count their launches by width too, which
`route_launches()` reads by the route the library plans for each width
(`ut_krows_route`): "cuda_cores" or "tensor_cores".  Several launchers
may share one source (and so one library): `csrc/gp_tile.cu` holds four.

Most kernels replace a Pallas kernel of the JAX package (`replaces`).
`RNG`, `FEATURES` and `SIMPLEX` replace none: `RNG` computes the port's
own counter hash (`rng.py`), `FEATURES` the GP's query features
(`Space.surrogate_features`), `SIMPLEX` NelderMead's proposal
(`ops/simplex.py`); on the CPU all three run as torch ops, bitwise
equal.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

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


# the routes of B's, C's and D's kernel-rows pass, by ut_krows_route's code
KROWS_ROUTES = ("cuda_cores", "tensor_cores")


class Kernel:
    """One hand-written kernel's launcher: its source, C symbol and
    signature, the TPU kernels it replaces, the loaded library, and the
    count of launches."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: Sequence[str],
                 limit: Optional[str] = None, routed: bool = False):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = tuple(replaces)     # "path:line" of each TPU kernel
        # the library's query of the largest N it takes, (f, var) -> int
        self.limit = limit
        self.launches = 0
        # drawn, by RNG; rows built, by FEATURES (0 for the others)
        self.elements = 0
        # launches by F, for the launchers with a kernel-rows pass (B, C,
        # D; None for the others): the route is asked of the library only
        # when read
        self.width_launches: Optional[Counter] = Counter() if routed \
            else None
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

    def call(self, device: torch.device, *args) -> int:
        """Call the C launcher on `device`'s current stream with `args`
        (tensors as their data pointers, None as a null pointer) and the
        stream's handle; -> its cudaError_t."""
        fn = self.function()
        argv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(device):
            return fn(*argv, torch.cuda.current_stream(device).cuda_stream)

    def launch(self, device: torch.device, *args,
               width: Optional[int] = None, elements: int = 0) -> None:
        """`call`, raise if it failed, and count one launch, one at
        `width` features (a routed launcher) and the `elements` drawn."""
        check(self.call(device, *args), self)
        self.launches += 1
        if width is not None:
            self.width_launches[width] += 1
        self.elements += elements

    def query(self, symbol: str, *args: int, restype=ctypes.c_int) -> int:
        """Call a host-only C function of the library that takes ints and
        returns an integer of `restype` (a launch-geometry limit or a
        scratch size the wrapper reads)."""
        fn = getattr(self.library(), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = restype
        return int(fn(*args))

    def krows_route(self, f: int) -> str:
        """The route of the kernel-rows pass at F features, as the
        library plans it (`ut_krows_route`)."""
        route = self.query("ut_krows_route", f)
        if route < 0:
            raise ValueError(f"no krows route for F={f}")
        return KROWS_ROUTES[route]

    def route_launches(self) -> Optional[Dict[str, int]]:
        """The launches counted so far by the route of their kernel-rows
        pass; None for a launcher without one."""
        if self.width_launches is None:
            return None
        out = dict.fromkeys(KROWS_ROUTES, 0)
        for f, n in self.width_launches.items():
            out[self.krows_route(f)] += n
        return out


def library_path(source: Path) -> Path:
    """The library built from `source`: named by a hash of the source, the
    headers beside it (`csrc/*.h`) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.h")):
        h.update(header.read_bytes())
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
# Their launch geometry lives in csrc/gp_plan.h alone (included by the
# .cu file); the wrappers read it through `Kernel.query`: the largest N
# (`limit`, by features and kind), for B, C and D the scratch size
# (ut_acquire_scratch_words), D's candidate count (ut_acquire_topk_slots)
# and krows' route at a width (ut_krows_route).
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
    limit="ut_acquire_max_train_rows", routed=True)
# C: ut_acquire_scores(qc, qk, xc, xk, alpha, kinv, params, u, scratch, b,
#    n, fc, fk, kind, stream); passes kinv_prep (K^-T), krows (k, mean),
#    wq (k K^-1 on the tensor cores in 3xTF32, q) and final (utility)
ACQ_SCORES = Kernel(
    name="acquire_scores", source="gp_tile.cu", symbol="ut_acquire_scores",
    argtypes=[_P] * 9 + [_I] * 5 + [_P],
    replaces=("uptune_tpu/ops/acquire.py:151",),        # _scores_kernel
    limit="ut_acquire_max_train_rows", routed=True)
# D: ut_acquire_topk(qc, qk, xc, xk, alpha, kinv, params, u, vals, idx,
#    scratch, b, n, fc, fk, kind, k, segs, stream); C's passes with a
#    per-chunk sort in the final pass, then topk_merge (ranks across
#    chunks); segs lists of b rows (an instance axis) in one launch, each
#    with its own top k
ACQ_TOPK = Kernel(
    name="acquire_topk", source="gp_tile.cu", symbol="ut_acquire_topk",
    argtypes=[_P] * 11 + [_I] * 7 + [_P],
    replaces=("uptune_tpu/ops/acquire.py:157",),        # _topk_kernel
    limit="ut_acquire_max_train_rows", routed=True)
# rng_block(keys, words, floats, rows, count, start, domain, stream): one
# block of the draws' counter hash for `rows` keys in one pass (floats
# null: whole words, for split keys); its wrapper is `rng.py::_block_cuda`.
# It replaces no TPU kernel: the JAX package draws with jax.random.
RNG = Kernel(
    name="rng_block", source="rng.cu", symbol="ut_rng_block",
    argtypes=[_P] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_uint] * 2
    + [_P],
    replaces=())
# surrogate_features(u, ld_u, perm, ld_p, kind, lanes, cols, items_of,
# out, b, d, p, f, stream): the GP's query features of b rows in one pass
# (`surrogate_feats_kernel`), the perm blocks side by side in one tensor.
# Its wrapper is `ops/features.py::features_cuda`.  It replaces no TPU
# kernel: the JAX package builds the features with XLA ops.
FEATURES = Kernel(
    name="surrogate_features", source="features.cu",
    symbol="ut_surrogate_features",
    argtypes=[_P, ctypes.c_longlong] * 2 + [_P] * 5 + [_I] * 4 + [_P],
    replaces=())
# simplex_propose(pts, vals, draws, phase, u, new_pts, new_vals, n, s, d,
# alpha, gamma, beta, sigma, inv_s, stream): NelderMead's proposal of n
# instances in one launch (`simplex_propose_kernel`).  Its wrapper is
# `ops/simplex.py::simplex_cuda`.  It replaces no TPU kernel: the JAX
# package proposes with XLA ops.
SIMPLEX = Kernel(
    name="simplex_propose", source="simplex.cu", symbol="ut_simplex_propose",
    argtypes=[_P] * 7 + [_I] * 3 + [ctypes.c_float] * 5 + [_P],
    replaces=())
KERNELS = (MERGE, GP_MEAN, GP_MEAN_VAR, ACQ_SCORES, ACQ_TOPK, RNG, FEATURES,
           SIMPLEX)


def counts() -> Counter:
    """Every kernel's counters as one record, zeros left out: (kernel,
    "launches" or "elements", None) and (kernel, "width_launches", F) ->
    count.  Records subtract and add as Counters."""
    snap = Counter()
    for k in KERNELS:
        snap[k, "launches", None] = k.launches
        snap[k, "elements", None] = k.elements
        for f, n in (k.width_launches or {}).items():
            snap[k, "width_launches", f] = n
    return +snap


def add(delta: Counter) -> None:
    """Add a `counts()` record to the kernels' counters."""
    for (k, field, f), n in delta.items():
        if f is None:
            setattr(k, field, getattr(k, field) + n)
        else:
            k.width_launches[f] += n


def restore(snap: Counter) -> None:
    """Set every kernel's counters to those of a `counts()` record."""
    for k in KERNELS:
        k.launches = k.elements = 0
        if k.width_launches is not None:
            k.width_launches.clear()
    add(snap)


def reset_launches() -> None:
    restore(Counter())


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
