"""Fused GP scoring: posterior mean (and variance term) per query tile.

Counterpart of `uptune_tpu/surrogate/pallas_score.py`, under the same
name so a reader finds it; here it holds CUDA wrappers, not Pallas.
Scoring a candidate batch against the GP needs the [B, N] cross-kernel;
the fused functions compute it one tile of query rows at a time and
contract it at once, with alpha (mean, `mu_n = k . alpha`) and with the
premasked K^-1 (variance term, `q = rowsum((k K^-1) * k)`), so nothing
of size [B, N] reaches device memory.  The predictive variance is then
`1 + noise - q`: EI and LCB are exact in the fused regime too.

Operands are the JAX package's `_prep` conventions: the continuous block
scaled by 1/ls, the categorical one-hot block by sqrt(1/(n_cat ls_cat))
(so its raw squared distance is the exponent of the Hamming factor),
alpha and K^-1 premasked.  Padded training rows then need no masking.

* `mean_tile_plain` / `mean_var_tile_plain` — the plain versions, tile
  by tile (the JAX tile math: distances through |a|^2 + |b|^2 - 2ab,
  clamped at 0; `tile_moments` per tile).  The CPU tests use them;
  `chip_smoke.py` holds the kernels against them on the card.
* `target_moments` — (mean, sd) in target units from the fused moments;
  `ops/acquire.py` builds its utilities on it too.
* `mean_tile_cuda` / `mean_var_tile_cuda` — the wrappers of launchers A
  and B in `csrc/gp_tile.cu`, which replace the six Pallas kernels
  `_score_kernel`, `_score_kernel_mixed`, `_score_kernel_expham` (A)
  and `_var_kernel`, `_var_kernel_mixed`, `_var_kernel_expham` (B).  A
  is one kernel: the distances through the same identity as the plain
  version, with both blocks centred on training row 0 and the cross term
  on the tensor cores in 3xTF32; it needs no scratch, so the wrapper
  allocates only the mean.  B runs the passes of the acquisition
  launchers (k K^-1 on the tensor cores) through a scratch buffer, sized
  by the library and allocated here (`launch_scratch`, which
  `ops/acquire.py` shares).
* `mean_tile` / `mean_var_tile` — route by the tensors' device: CPU
  tensors take the plain version, CUDA tensors launch or raise.
* `gp_mean_scores` / `gp_mean_var_scores` — the entries: a GPState and a
  [B, F] query batch -> mean (and sd) in target units.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import native

# query rows of one plain-version tile (the JAX VTILE)
TILE = 1024
# flat rows from which gp.score_flat takes the fused path
PALLAS_MIN_POOL = 4096

MEAN_KERNEL = native.GP_MEAN
MEAN_VAR_KERNEL = native.GP_MEAN_VAR


class Blocks(NamedTuple):
    """Pre-scaled operands of one fused call (`prep_blocks`)."""
    qc: Optional[torch.Tensor]     # [B, Fc] queries, continuous / ls
    qk: Optional[torch.Tensor]     # [B, Fk] queries, one-hot * cat_s
    xc: Optional[torch.Tensor]     # [N, Fc] training rows, same scaling
    xk: Optional[torch.Tensor]     # [N, Fk]
    alpha: torch.Tensor            # [N] premasked


# -- tile math (plain) ----------------------------------------------------------
def tile_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d2 = ((a * a).sum(dim=1, keepdim=True) + (b * b).sum(dim=1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.clamp_min(d2, 0.0)


def matern_tile(d2: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(d2 + 1e-12)
    s5d = math.sqrt(5.0) * d
    return (1.0 + s5d + (5.0 / 3.0) * d2) * torch.exp(-s5d)


def kernel_tile(qc, qk, xc, xk) -> torch.Tensor:
    """[T, N] cross-kernel of a query tile: Matérn over the continuous
    block times exp(-d2) over the categorical block (either may be
    absent)."""
    if qc is None:
        return torch.exp(-tile_d2(qk, xk))
    k = matern_tile(tile_d2(qc, xc))
    if qk is not None:
        k = k * torch.exp(-tile_d2(qk, xk))
    return k


def n_rows(qc, qk) -> int:
    return (qc if qc is not None else qk).shape[0]


def tiles(qc, qk):
    """(qc tile, qk tile) pairs of TILE rows (the last one ragged)."""
    for s in range(0, n_rows(qc, qk), TILE):
        yield (None if qc is None else qc[s:s + TILE],
               None if qk is None else qk[s:s + TILE])


def tile_moments(k: torch.Tensor, alpha, kinv=None):
    """(mu_n, q) of one kernel tile: mu_n = k . alpha and, given the
    premasked K^-1, q = rowsum((k K^-1) * k) (else None)."""
    mu_n = k @ alpha
    return mu_n, None if kinv is None else ((k @ kinv) * k).sum(dim=1)


def mean_tile_plain(qc, qk, xc, xk, alpha) -> torch.Tensor:
    """The plain version of launcher A: mu_n [B] = k . alpha, tile by
    tile."""
    return torch.cat([tile_moments(kernel_tile(tc, tk, xc, xk), alpha)[0]
                      for tc, tk in tiles(qc, qk)])


def mean_var_tile_plain(qc, qk, xc, xk, alpha, kinv
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of launcher B: (mu_n [B], q [B]), tile by
    tile."""
    parts = [tile_moments(kernel_tile(tc, tk, xc, xk), alpha, kinv)
             for tc, tk in tiles(qc, qk)]
    return (torch.cat([mu for mu, _ in parts]),
            torch.cat([q for _, q in parts]))


def target_moments(mu_n: torch.Tensor, q: Optional[torch.Tensor], noise,
                   y_mean, y_std):
    """(mean, sd) in target units from the fused moments; sd is None
    when q is.  The predictive variance is 1 + noise - q, floored at
    1e-9."""
    mu = mu_n * y_std + y_mean
    if q is None:
        return mu, None
    return mu, torch.sqrt(torch.clamp_min(1.0 + noise - q, 1e-9)) * y_std


# -- the CUDA wrappers ------------------------------------------------------------
def operand_dims(kernel: native.Kernel, qc, qk, xc, xk, alpha, kinv=None
                 ) -> Tuple[int, int, int, int]:
    """Pairs, dtype, shape, contiguity and one device of a fused call's
    operands, whatever that device is; -> (B, N, Fc, Fk).  Raises on
    anything the kernel does not take."""
    what = kernel.name
    if (qc is None) != (xc is None) or (qk is None) != (xk is None):
        raise ValueError(f"{what}: qc/xc and qk/xk come in pairs")
    if qc is None and qk is None:
        raise ValueError(f"{what}: no feature block")
    dev = alpha.device
    b = n_rows(qc, qk)
    n = alpha.shape[0]
    fc = 0 if qc is None else qc.shape[1]
    fk = 0 if qk is None else qk.shape[1]
    want = {"qc": (qc, (b, fc)), "qk": (qk, (b, fk)), "xc": (xc, (n, fc)),
            "xk": (xk, (n, fk)), "alpha": (alpha, (n,)),
            "kinv": (kinv, (n, n))}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            f"torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if b == 0 or n == 0:
        raise ValueError(f"{what}: empty operand (B={b}, N={n})")
    return b, n, fc, fk


def require_cuda(kernel: native.Kernel, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{kernel.name} needs CUDA tensors, got {dev}")


def check_train_rows(kernel: native.Kernel, n: int, f: int, var: bool):
    """Raise when the launcher does not take N training rows of F
    features; the limit is the library's (the kernel's `limit` query), so
    the launch geometry lives in csrc/gp_tile.cu alone."""
    limit = kernel.query(kernel.limit, f, int(var))
    if n > limit:
        raise ValueError(
            f"{kernel.name}: N={n} training rows at F={f} do not fit the "
            f"launcher (at most {limit})")


def krows_route(f: int) -> str:
    """The route of B's, C's and D's kernel-rows pass at F features, as
    the library plans it (`csrc/gp_plan.h`): "cuda_cores" (up to 361
    features, all in one block) or "tensor_cores" (the distances' cross
    term on wgmma in 3xTF32, 32 features at a time)."""
    return MEAN_VAR_KERNEL.krows_route(f)


def scratch_words(kernel: native.Kernel, b: int, n: int, var: bool,
                  k: int = 0, segments: int = 1) -> int:
    """The float32 words of scratch launcher B (var, k = 0), C (k = 0) or
    D (top k; over `segments` lists of B rows) needs for B query and N
    training rows, as the library computes it; `var` for the kinds that
    take K^-1."""
    words = kernel.query("ut_acquire_scratch_words", b, n, int(var), k,
                         segments, restype=ctypes.c_longlong)
    if words < 0:
        raise ValueError(f"{kernel.name}: no launch for B={b}, N={n}, k={k}"
                         f", segments={segments}")
    return words


def check_scratch(kernel: native.Kernel, scratch: torch.Tensor, words: int,
                  dev: torch.device) -> None:
    if (scratch.device != dev or scratch.dtype != torch.float32
            or scratch.dim() != 1 or not scratch.is_contiguous()
            or scratch.numel() < words):
        raise ValueError(
            f"{kernel.name}: scratch must be a contiguous 1-D float32 tensor "
            f"of at least {words} elements on {dev}, got "
            f"{scratch.dtype} {tuple(scratch.shape)} on {scratch.device}")


def launch_scratch(kernel: native.Kernel, b: int, n: int, f: int, var: bool,
                   k: int, scratch: Optional[torch.Tensor],
                   dev: torch.device, segments: int = 1) -> torch.Tensor:
    """The last checks before a launch of B, C or D, after the operands'
    own: a given scratch against the library's size (on any device), then
    a CUDA device, then N against the library's limit.  -> the scratch,
    allocated from the caching allocator when None."""
    if scratch is not None:
        check_scratch(kernel, scratch,
                      scratch_words(kernel, b, n, var, k, segments), dev)
    require_cuda(kernel, dev)
    check_train_rows(kernel, n, f, var)
    if scratch is None:
        scratch = torch.empty(scratch_words(kernel, b, n, var, k, segments),
                              dtype=torch.float32, device=dev)
    return scratch


def mean_tile_cuda(qc, qk, xc, xk, alpha) -> torch.Tensor:
    """Launch A (`ut_gp_mean`): mu_n [B] on the current stream."""
    b, n, fc, fk = operand_dims(MEAN_KERNEL, qc, qk, xc, xk, alpha)
    dev = alpha.device
    require_cuda(MEAN_KERNEL, dev)
    check_train_rows(MEAN_KERNEL, n, fc + fk, False)
    mu = torch.empty(b, dtype=torch.float32, device=dev)
    MEAN_KERNEL.launch(dev, qc, qk, xc, xk, alpha, mu, b, n, fc, fk)
    return mu


def mean_var_tile_cuda(qc, qk, xc, xk, alpha, kinv,
                       scratch: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B (`ut_gp_mean_var`): (mu_n [B], q [B]).  `scratch` holds
    the passes' data (the [B, N] kernel rows among them); allocated when
    None."""
    b, n, fc, fk = operand_dims(MEAN_VAR_KERNEL, qc, qk, xc, xk, alpha, kinv)
    dev = alpha.device
    scratch = launch_scratch(MEAN_VAR_KERNEL, b, n, fc + fk, True, 0,
                             scratch, dev)
    mu = torch.empty(b, dtype=torch.float32, device=dev)
    q = torch.empty(b, dtype=torch.float32, device=dev)
    MEAN_VAR_KERNEL.launch(dev, qc, qk, xc, xk, alpha, kinv, mu, q, scratch,
                           b, n, fc, fk, width=fc + fk)
    return mu, q


def mean_tile(qc, qk, xc, xk, alpha) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch A."""
    if alpha.device.type == "cpu":
        return mean_tile_plain(qc, qk, xc, xk, alpha)
    return mean_tile_cuda(qc, qk, xc, xk, alpha)


def mean_var_tile(qc, qk, xc, xk, alpha, kinv):
    """CPU tensors take the plain version; CUDA tensors launch B."""
    if alpha.device.type == "cpu":
        return mean_var_tile_plain(qc, qk, xc, xk, alpha, kinv)
    return mean_var_tile_cuda(qc, qk, xc, xk, alpha, kinv)


# -- entries --------------------------------------------------------------------------
def prep_blocks(state, xq: torch.Tensor, n_cont: Optional[int],
                n_cat: int) -> Blocks:
    """The pre-scaled operands of a fused call (the JAX `_prep`
    conventions).  `n_cont`/`n_cat` must match the fit."""
    f = xq.shape[1]
    xq32 = xq.to(torch.float32).contiguous()
    x32 = state.x.to(torch.float32)
    alpha = (state.alpha.to(torch.float32) * state.mask).contiguous()
    if n_cont is not None and n_cat and n_cont < f:
        cat_s = torch.sqrt(1.0 / (float(n_cat) * torch.as_tensor(
            state.ls_cat, dtype=torch.float32, device=xq.device)))
        if n_cont == 0:
            return Blocks(None, (xq32 * cat_s).contiguous(), None,
                          (x32 * cat_s).contiguous(), alpha)
        ls = state.lengthscale
        return Blocks((xq32[:, :n_cont] / ls).contiguous(),
                      (xq32[:, n_cont:] * cat_s).contiguous(),
                      (x32[:, :n_cont] / ls).contiguous(),
                      (x32[:, n_cont:] * cat_s).contiguous(), alpha)
    return Blocks((xq32 / state.lengthscale).contiguous(), None,
                  (x32 / state.lengthscale).contiguous(), None, alpha)


def state_kinv(state) -> torch.Tensor:
    """The premasked K^-1: the one attached at fit time, else computed."""
    if state.kinv is None:
        from . import gp
        state = gp.precompute_kinv(state)
    return state.kinv.to(torch.float32).contiguous()


def gp_mean_scores(state, xq: torch.Tensor, n_cont: Optional[int] = None,
                   n_cat: int = 0) -> torch.Tensor:
    """Posterior mean [B] in target units for a [B, F] query batch,
    without the [B, N] cross-kernel in device memory; equal to
    `gp.predict(...)[0]` within float tolerance."""
    mu_n = mean_tile(*prep_blocks(state, xq, n_cont, n_cat))
    return target_moments(mu_n, None, state.noise, state.y_mean,
                          state.y_std)[0]


def gp_mean_var_scores(state, xq: torch.Tensor,
                       n_cont: Optional[int] = None, n_cat: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior (mean [B], sd [B]) in target units, fused; equal to
    `gp.predict` within float tolerance."""
    mu_n, q = mean_var_tile(*prep_blocks(state, xq, n_cont, n_cat),
                            state_kinv(state))
    return target_moments(mu_n, q, state.noise, state.y_mean, state.y_std)

