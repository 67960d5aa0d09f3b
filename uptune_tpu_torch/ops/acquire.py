"""Fused acquisition: surrogate score + acquisition transform + top-k.

Counterpart of `uptune_tpu/ops/acquire.py`.  One pass over a flat
candidate batch computes, per tile of query rows, the cross-kernel
against the GP's training rows, the posterior moments (the
`surrogate/pallas_score.py` tiling), and the acquisition UTILITY
(higher = better): -mean ('mean'), EI ('ei', against `best_y`) or
-(mu - beta*sd) ('lcb').  The top-k variant then keeps only the k best
rows, values descending, ties broken to the lowest flat index (the
`lax.top_k` order, `acquire.py:33-39` of the JAX package).

* `utilities` — the acquisition transform of the fused moments, on
  `pallas_score.target_moments`.
* `utilities_plain` / `topk_plain` — the plain versions (the JAX
  package's per-tile XLA fallback: `pallas_score`'s plain tiles, then
  `utilities`, then a stable sort for top-k).  The CPU tests use them;
  `chip_smoke.py` holds the kernels against them on the card.
* `scores_cuda` / `topk_cuda` — the wrappers of launchers C and D in
  `csrc/gp_tile.cu`, which replace the Pallas kernels `_scores_kernel`
  and `_topk_kernel`.  They allocate the passes' scratch (its size is
  the library's).  D selects in two levels on the card and writes
  candidate lists, each sorted by (value desc, index asc): at the main
  path's sizes one list, the top k itself; otherwise one stable
  `torch.sort` over them (they concatenate in index order, so a
  positional tie-break is the global one) gives the top k.
* `topk_segments_cuda` — D over an instance axis: S lists of B rows
  scored against one GP in one launch, each with its own top k.
* `scores_tile` / `topk_tile` — route by the tensors' device: CPU
  tensors take the plain version, CUDA tensors launch or raise.  D goes
  through the custom op `uptune_tpu_torch::acquire_topk`, whose vmap
  rule ranks N instances' candidates (the GP shared) in one launch of
  `topk_segments_cuda` (on the CPU, `topk_plain` per instance), so
  `torch.func.vmap` over `acquire_topk` is one launch, as the merge's op
  is.  (A `ctypes` launch on `data_ptr()` cannot see vmap's batched
  tensors itself.)
* `acquire_scores` / `acquire_topk` — the entries (a GPState and a
  [B, F] query batch).
* `acquire_scores_ref` / `acquire_topk_ref` — the unfused staging that
  materializes the [B, N] cross-kernel through `torch.matmul`: the
  yardstick `chip_smoke.py` times, never on the main path.

The JAX package's route knob (`ops/routing.py`) and its TPU VMEM facts
(`kernel_schema`) are not ported: the tensor's device decides.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import native
from ..surrogate import gp
from ..surrogate.pallas_score import (Blocks, kernel_tile, launch_scratch,
                                      mean_tile_plain, mean_var_tile_plain,
                                      n_rows, operand_dims, prep_blocks,
                                      state_kinv, target_moments,
                                      tile_moments)

KINDS = ("mean", "ei", "lcb")
KIND_CODE = {"mean": 0, "ei": 1, "lcb": 2}     # csrc/gp_tile.cu `Kind`

SCORES_KERNEL = native.ACQ_SCORES
TOPK_KERNEL = native.ACQ_TOPK


# -- plain versions ----------------------------------------------------------------
def utilities(mu_n: torch.Tensor, q: Optional[torch.Tensor], params,
              kind: str) -> torch.Tensor:
    """Utility from the fused moments (q None for 'mean'); params are
    (noise, y_mean, y_std, best_y, beta)."""
    mu, sd = target_moments(mu_n, q, params[0], params[1], params[2])
    if kind == "mean":
        return -mu
    if kind == "ei":
        return gp.ei_from_moments(mu, sd, params[3])
    return -(mu - params[4] * sd)


def utilities_plain(qc, qk, xc, xk, alpha, kinv, params, kind: str
                    ) -> torch.Tensor:
    """The plain version of launcher C: [B] utilities from the plain
    tiles (the JAX `_utility_tile` under `_utilities_xla`)."""
    if kinv is None:
        return utilities(mean_tile_plain(qc, qk, xc, xk, alpha), None,
                         params, kind)
    return utilities(*mean_var_tile_plain(qc, qk, xc, xk, alpha, kinv),
                     params, kind)


def select_topk(u: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of `u` along its last dim, values descending, ties
    to the lowest index (a stable sort; `torch.topk` does not promise
    that order)."""
    order = torch.sort(u, descending=True, stable=True).indices[..., :k]
    return u.gather(-1, order), order.to(torch.int32)


def topk_plain(qc, qk, xc, xk, alpha, kinv, params, kind: str, k: int):
    """The plain version of launcher D: utilities, then `select_topk`."""
    return select_topk(
        utilities_plain(qc, qk, xc, xk, alpha, kinv, params, kind), k)


# -- the CUDA wrappers -----------------------------------------------------------------
def _check(kind: str, best_y=0.0) -> None:
    """Raise on an unknown kind, and on 'ei' without best_y."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "ei" and best_y is None:
        raise ValueError("kind='ei' needs best_y")


def _check_launch(kernel: native.Kernel, kind: str, qc, qk, xc, xk, alpha,
                  kinv, params, scratch, k: Optional[int] = None,
                  segments: int = 1
                  ) -> Tuple[int, int, int, int, torch.Tensor]:
    """Operands (`operand_dims`), the kind, K^-1 given for exactly the
    variance kinds and the [5] scalar pack, on any device; then
    `launch_scratch`: a given scratch buffer, a CUDA device and N against
    the library's limit.  `k` is D's top k (None for C); D's query rows
    are `segments` lists of equal length.  -> (B, N, Fc, Fk, scratch), B
    a segment's rows, the scratch allocated when None."""
    _check(kind)
    if (kind == "mean") != (kinv is None):
        raise ValueError(f"kind {kind!r} takes kinv "
                         f"{'None' if kind == 'mean' else '[N, N]'}")
    b, n, fc, fk = operand_dims(kernel, qc, qk, xc, xk, alpha, kinv)
    dev = alpha.device
    if (params.device != dev or params.dtype != torch.float32
            or tuple(params.shape) != (5,) or not params.is_contiguous()):
        raise ValueError(f"{kernel.name}: params must be a contiguous [5] "
                         f"float32 tensor on {dev}")
    if segments < 1 or b % segments:   # the library bounds the segments
        raise ValueError(f"{kernel.name}: {b} query rows do not split into "
                         f"{segments} segments")
    b //= segments
    if k is not None and not 1 <= k <= b:
        raise ValueError(f"k must be in [1, {b}]: {k}")
    scratch = launch_scratch(kernel, b, n, fc + fk, kinv is not None, k or 0,
                             scratch, dev, segments)
    return b, n, fc, fk, scratch


def scores_cuda(qc, qk, xc, xk, alpha, kinv, params, kind: str,
                scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch C (`ut_acquire_scores`): [B] utilities.  `scratch` holds the
    passes' data (the [B, N] kernel rows among them); allocated when
    None."""
    b, n, fc, fk, scratch = _check_launch(SCORES_KERNEL, kind, qc, qk, xc,
                                          xk, alpha, kinv, params, scratch)
    dev = alpha.device
    u = torch.empty(b, dtype=torch.float32, device=dev)
    SCORES_KERNEL.launch(dev, qc, qk, xc, xk, alpha, kinv, params, u,
                         scratch, b, n, fc, fk, KIND_CODE[kind],
                         width=fc + fk)
    return u


def topk_segments_cuda(qc, qk, xc, xk, alpha, kinv, params, kind: str,
                       k: int, segments: int,
                       scratch: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch D (`ut_acquire_topk`) once over `segments` lists: the query
    blocks hold S x B rows, segment s its rows [s B, (s + 1) B), all
    scored against the one GP; each segment's candidate lists of its k
    best, each sorted, then one stable sort per segment over them unless
    the card wrote a single list -> (values [S, k] descending, indices
    [S, k] int32 within each segment)."""
    b, n, fc, fk, scratch = _check_launch(TOPK_KERNEL, kind, qc, qk, xc, xk,
                                          alpha, kinv, params, scratch, k,
                                          segments)
    dev = alpha.device
    slots = TOPK_KERNEL.query("ut_acquire_topk_slots", b, k)
    u = torch.empty(segments * b, dtype=torch.float32, device=dev)
    vals = torch.empty(segments, slots, dtype=torch.float32, device=dev)
    idx = torch.empty(segments, slots, dtype=torch.int32, device=dev)
    TOPK_KERNEL.launch(dev, qc, qk, xc, xk, alpha, kinv, params, u, vals, idx,
                       scratch, b, n, fc, fk, KIND_CODE[kind], k, segments,
                       width=fc + fk)
    if slots != k:                  # several lists: merge them here
        vals, pos = select_topk(vals, k)
        idx = idx.gather(-1, pos.long())
    # the JAX clamp of unfilled lanes (acquire.py:275)
    return vals, torch.clamp_max(idx, b - 1)


def topk_cuda(qc, qk, xc, xk, alpha, kinv, params, kind: str, k: int,
              scratch: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch D (`ut_acquire_topk`) on one list: candidate lists of the k
    best, each sorted, then one stable sort over them unless the card
    wrote a single list -> (values [k] descending, flat indices [k]
    int32)."""
    vals, idx = topk_segments_cuda(qc, qk, xc, xk, alpha, kinv, params, kind,
                                   k, 1, scratch)
    return vals[0], idx[0]


def scores_tile(qc, qk, xc, xk, alpha, kinv, params, kind: str):
    """CPU tensors take the plain version; CUDA tensors launch C."""
    if alpha.device.type == "cpu":
        return utilities_plain(qc, qk, xc, xk, alpha, kinv, params, kind)
    return scores_cuda(qc, qk, xc, xk, alpha, kinv, params, kind)


def _topk_impl(qc, qk, xc, xk, alpha, kinv, params, kind: str, k: int):
    if alpha.device.type == "cpu":
        return topk_plain(qc, qk, xc, xk, alpha, kinv, params, kind, k)
    return topk_cuda(qc, qk, xc, xk, alpha, kinv, params, kind, k)


_topk_op = torch.library.custom_op(
    "uptune_tpu_torch::acquire_topk", _topk_impl, mutates_args=(),
    schema="(Tensor? qc, Tensor? qk, Tensor? xc, Tensor? xk, Tensor alpha, "
           "Tensor? kinv, Tensor params, str kind, int k) "
           "-> (Tensor, Tensor)")


def topk_segments_tile(qc, qk, xc, xk, alpha, kinv, params, kind: str,
                       k: int, segments: int):
    """D over `segments` equal lists of the query rows, against one GP:
    CPU tensors take `topk_plain` per segment, CUDA tensors launch D once
    (`topk_segments_cuda`).  -> (values [S, k], indices [S, k] within
    each segment)."""
    if alpha.device.type != "cpu":
        return topk_segments_cuda(qc, qk, xc, xk, alpha, kinv, params, kind,
                                  k, segments)
    b = n_rows(qc, qk) // segments
    out = [topk_plain(None if qc is None else qc[s * b:(s + 1) * b],
                      None if qk is None else qk[s * b:(s + 1) * b],
                      xc, xk, alpha, kinv, params, kind, k)
           for s in range(segments)]
    return (torch.stack([v for v, _ in out]),
            torch.stack([i for _, i in out]))


def _topk_vmap(info, in_dims, qc, qk, xc, xk, alpha, kinv, params, kind, k):
    """vmap over D: the query rows carry the instance axis and the GP
    operands are shared (the engine's programs score every instance
    against one snapshot), so the instances' lists stack into segments
    of one launch.  A batched GP operand is not a path of those programs
    and raises."""
    n = info.batch_size
    if any(d is not None for d in in_dims[2:7]):
        raise ValueError(
            "acquire_topk under vmap takes the instance axis on the query "
            "rows only: the GP operands (xc, xk, alpha, kinv, params) are "
            "shared by every instance")

    def stack(t, d):
        if t is None:
            return None
        t = t.movedim(d, 0) if d is not None else t.expand(
            (n,) + tuple(t.shape))
        return t.reshape(n * t.shape[1], t.shape[2]).contiguous()
    vals, idx = topk_segments_tile(stack(qc, in_dims[0]),
                                   stack(qk, in_dims[1]), xc, xk, alpha,
                                   kinv, params, kind, k, n)
    return (vals, idx), (0, 0)


_topk_op.register_vmap(_topk_vmap)


def topk_tile(qc, qk, xc, xk, alpha, kinv, params, kind: str, k: int):
    """CPU tensors take the plain version; CUDA tensors launch D (through
    the custom op, so that under `torch.func.vmap` all instances rank in
    one launch)."""
    return tuple(_topk_op(qc, qk, xc, xk, alpha, kinv, params, kind, k))


# -- entries ----------------------------------------------------------------------------
def prep(state, xq: torch.Tensor, kind: str, best_y, beta: float,
         n_cont: Optional[int], n_cat: int
         ) -> Tuple[Blocks, Optional[torch.Tensor], torch.Tensor]:
    """(pre-scaled blocks, premasked K^-1 or None for 'mean', params [5]:
    noise, y_mean, y_std, best_y, beta) — the JAX `_prep` conventions.
    Nothing is read back to the host."""
    dev = xq.device
    blocks = prep_blocks(state, xq, n_cont, n_cat)
    kinv = None if kind == "mean" else state_kinv(state)

    def f32(v):                      # a number fills on the device: no copy
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.float32).reshape(())
        return torch.full((), float(v), dtype=torch.float32, device=dev)
    params = torch.stack([
        f32(state.noise), f32(state.y_mean), f32(state.y_std),
        f32(0.0 if best_y is None else best_y), f32(beta)])
    return blocks, kinv, params


def acquire_scores(state, xq: torch.Tensor, kind: str = "mean", best_y=None,
                   beta: float = 2.0, n_cont: Optional[int] = None,
                   n_cat: int = 0) -> torch.Tensor:
    """Fused acquisition utilities [B] (higher = better) for a [B, F]
    query batch against a fitted GPState."""
    _check(kind, best_y)
    blocks, kinv, params = prep(state, xq, kind, best_y, beta, n_cont, n_cat)
    return scores_tile(*blocks, kinv, params, kind)


def acquire_topk(state, xq: torch.Tensor, k: int, kind: str = "mean",
                 best_y=None, beta: float = 2.0,
                 n_cont: Optional[int] = None, n_cat: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused score + acquisition + top-k: (utilities [k] descending, flat
    indices [k] int32), ties to the lowest index; `k` in [1, B]."""
    _check(kind, best_y)
    b = xq.shape[0]
    if not 1 <= k <= b:
        raise ValueError(f"k must be in [1, {b}]: {k}")
    blocks, kinv, params = prep(state, xq, kind, best_y, beta, n_cont, n_cat)
    return topk_tile(*blocks, kinv, params, kind, k)


def acquire_scores_ref(state, xq: torch.Tensor, kind: str = "mean",
                       best_y=None, beta: float = 2.0,
                       n_cont: Optional[int] = None, n_cat: int = 0
                       ) -> torch.Tensor:
    """The unfused staging: the whole [B, N] cross-kernel and the [B]
    moments materialized, then the transform."""
    _check(kind, best_y)
    blocks, kinv, params = prep(state, xq, kind, best_y, beta, n_cont, n_cat)
    return utilities_ref(*blocks, kinv, params, kind)


def utilities_ref(qc, qk, xc, xk, alpha, kinv, params, kind: str
                  ) -> torch.Tensor:
    """`acquire_scores_ref` on prepared operands: one un-tiled pass."""
    return utilities(*tile_moments(kernel_tile(qc, qk, xc, xk), alpha, kinv),
                     params, kind)


def acquire_topk_ref(state, xq: torch.Tensor, k: int, kind: str = "mean",
                     best_y=None, beta: float = 2.0,
                     n_cont: Optional[int] = None, n_cat: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused top-k: the full utility vector, then a stable sort."""
    return select_topk(acquire_scores_ref(state, xq, kind, best_y, beta,
                                          n_cont, n_cat), k)
