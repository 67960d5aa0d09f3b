"""NelderMead's proposal in one kernel (`csrc/simplex.cu`).

`NelderMead.propose` takes its batch and its sorted state from
`simplex_propose`: on the CPU the chain of torch ops below
(`propose_chain`), unchanged; on a CUDA state one launch of
`native.SIMPLEX`, which computes the same float32 outputs bitwise (the
order, the arithmetic and its rounding are in the kernel's source).  The
kernel reads the phase on the device, so a call allocates its outputs
alone and never waits on the host, and graph "propose" captures it.

* `propose_chain` — the plain version, which the CPU runs.
* `simplex_cuda` — the wrapper: checks the operands of N instances,
  allocates the outputs and launches once for all of them.
* `simplex_propose` — the entry: the chain for a CPU state, else the
  custom op `uptune_tpu_torch::simplex_propose`, whose vmap rule stacks
  the instances into one launch (a `ctypes` launch on `data_ptr()`
  cannot see vmap's batched tensors), as `surrogate_features`' op does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import native

INIT, LOOP = 0, 1               # a simplex state's phases

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _centroid(pts: torch.Tensor) -> torch.Tensor:
    """The mean of the S simplex points as XLA computes `jnp.mean(pts, 0)`:
    the rows summed in order, then times the f32 reciprocal of S.
    `torch.mean` (and `torch.cumsum`, which accumulates f32 in f64 on the
    CPU) round differently, and the reflection amplifies the ulp."""
    acc = pts[0]
    for row in pts[1:]:
        acc = acc + row
    return acc * (1.0 / pts.shape[0])


def propose_chain(pts_u: torch.Tensor, vals: torch.Tensor,
                  draws: torch.Tensor, phase: torch.Tensor, alpha: float,
                  gamma: float, beta: float, sigma: float) -> Outputs:
    """One Nelder-Mead round from a simplex [S, D], its values [S], the
    INIT phase's padding rows [3, D] and its phase -> (the batch
    [S + 3, D], the new state's points and values): in INIT the simplex
    and the padding, the state as it is; otherwise the reflection,
    expansion, outside and inside contraction and the S - 1 shrink
    points of the sorted simplex, which the state keeps for observe."""
    # stable: jnp.argsort is, and at INIT every value is +inf
    order = torch.argsort(vals, stable=True)
    pts = pts_u[order]
    svals = vals[order]
    c = _centroid(pts)          # calculate_centroid: all points
    worst = pts[-1]
    refl = torch.clamp(c + alpha * (c - worst), 0, 1)
    expa = torch.clamp(c + gamma * (refl - c), 0, 1)
    c_out = torch.clamp(c + beta * (refl - c), 0, 1)
    c_in = torch.clamp(c + beta * (worst - c), 0, 1)
    shrink = pts[0][None, :] + sigma * (pts[1:] - pts[0][None, :])
    loop_batch = torch.cat(
        [refl[None], expa[None], c_out[None], c_in[None], shrink], dim=0)
    init_batch = torch.cat([pts_u, draws], dim=0)
    is_init = phase == INIT
    return (torch.where(is_init, init_batch, loop_batch),
            torch.where(is_init, pts_u, pts),
            torch.where(is_init, vals, svals))


def simplex_cuda(pts: torch.Tensor, vals: torch.Tensor, draws: torch.Tensor,
                 phase: torch.Tensor, alpha: float, gamma: float,
                 beta: float, sigma: float) -> Outputs:
    """Launch the kernel on the current stream over N instances: pts
    [N, S, D], vals [N, S], draws [N, 3, D] float32 and phase [N] int32
    -> (u [N, S + 3, D], pts [N, S, D], vals [N, S])."""
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"the simplex kernel needs a CUDA state, got {dev}")
    if pts.dim() != 3 or pts.dtype != torch.float32:
        raise ValueError(f"pts is [N, S, D] float32, got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    n, s, d = pts.shape
    want = {"vals": (vals, (n, s), torch.float32),
            "draws": (draws, (n, 3, d), torch.float32),
            "phase": (phase, (n,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if t.shape != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name} is {list(shape)} {dtype} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    pts, vals, draws, phase = (t.contiguous() for t in (pts, vals, draws,
                                                        phase))
    u = torch.empty(n, s + 3, d, dtype=torch.float32, device=dev)
    new_pts = torch.empty_like(pts)
    new_vals = torch.empty_like(vals)
    if n and d:
        native.SIMPLEX.launch(dev, pts, vals, draws, phase, u, new_pts,
                              new_vals, n, s, d, alpha, gamma, beta, sigma,
                              1.0 / s)
    return u, new_pts, new_vals


def _impl(pts, vals, draws, phase, alpha, gamma, beta, sigma):
    # the wrapper looked up at each call, so that a CPU test can stand in
    # for the launch
    return simplex_cuda(pts, vals, draws, phase, alpha, gamma, beta, sigma)


_op = torch.library.custom_op(
    "uptune_tpu_torch::simplex_propose", _impl, mutates_args=(),
    schema="(Tensor pts, Tensor vals, Tensor draws, Tensor phase, "
           "float alpha, float gamma, float beta, float sigma) -> "
           "(Tensor, Tensor, Tensor)")


def _vmap(info, in_dims, pts, vals, draws, phase, *coeffs):
    """vmap over the op: the instances of every vmapped call stack into
    one launch; an operand without the axis is shared by all."""
    n = info.batch_size

    def stack(t, dim):
        t = t.movedim(dim, 0) if dim is not None else t.expand(
            (n,) + tuple(t.shape))
        return t.reshape((n * t.shape[1],) + tuple(t.shape[2:]))
    outs = _op(*(stack(t, dim) for t, dim in zip(
        (pts, vals, draws, phase), in_dims)), *coeffs)
    return tuple(o.reshape((n, o.shape[0] // n) + tuple(o.shape[1:]))
                 for o in outs), (0, 0, 0)


_op.register_vmap(_vmap)


def simplex_propose(pts_u: torch.Tensor, vals: torch.Tensor,
                    draws: torch.Tensor, phase: torch.Tensor, alpha: float,
                    gamma: float, beta: float, sigma: float) -> Outputs:
    """`propose_chain`'s outputs: the chain for a CPU state, one launch
    of the kernel for a CUDA state (under vmap one for all instances)."""
    if pts_u.device.type == "cpu":
        return propose_chain(pts_u, vals, draws, phase, alpha, gamma, beta,
                             sigma)
    u, pts, svals = _op(pts_u[None], vals[None], draws[None],
                        phase.reshape(1), float(alpha), float(gamma),
                        float(beta), float(sigma))
    return u[0], pts[0], svals[0]
