"""The H100's peaks and the least time of each hand-written kernel.

A kernel's least time is counted from the function it computes and its
shapes, never from how it is built: the larger of its bytes at HBM's rate
(each input read once, each output written once) and its operations at
the rate that gives float32-accurate products on this chip.  Frozen from
`chip_smoke.py` (`gp_bound`, `launcher_bounds` and the merge's bytes), so
that a change to a kernel changes no count here.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
"""
from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12       # float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12      # dense TF32 on the tensor cores


def gp_bound(b: int, n: int, f: int, var: bool, out_bytes: int
             ) -> Dict[str, float]:
    """One GP launcher call over `b` query rows, `n` training rows and
    `f` features: its operations (distances 2bnf, mean 2bn, and for the
    variance kinds k K^-1 2bn^2 plus q 2bn) or its bytes (queries,
    training rows, alpha, K^-1, outputs, each once) over HBM's rate,
    whichever takes longer.  The distances' cross term and k K^-1 are
    matrix products that the tensor cores take in 3xTF32, which keeps
    float32's accuracy: both count three times at the TF32 rate, the rest
    at the float32 rate."""
    mm = 2 * b * n * n if var else 0
    rest = 2 * b * n * f + 2 * b * n + (2 * b * n if var else 0)
    tc = 2 * b * n * f + mm
    nbytes = 4 * (b * f + n * f + n + (n * n if var else 0)) + out_bytes
    t_ops = 3 * tc / TF32_FLOP_PER_S + (mm + rest - tc) / FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": mm + rest, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def acquire_scores_bound(b: int, n: int, f: int) -> Dict[str, float]:
    """Launcher C: [b] utilities (and its five scalars)."""
    return gp_bound(b, n, f, True, 4 * b + 20)


def acquire_topk_bound(b: int, n: int, f: int, k: int) -> Dict[str, float]:
    """Launcher D: the top k values and indices (and its five scalars)."""
    return gp_bound(b, n, f, True, 8 * k + 20)


def merge_rows_bound(cap: int, b: int) -> Dict[str, float]:
    """The merge of a b-row batch into a cap-row history: each of the cap
    output rows (24 bytes: h0, h1 int64, qor, age) written once and read
    once from its one source row, and every position (4 bytes) read
    once."""
    nbytes = 48 * cap + 4 * b
    return {"flops": 0, "bytes": nbytes,
            "bound_s": nbytes / HBM_BYTES_PER_S, "bound_by": "bytes"}
