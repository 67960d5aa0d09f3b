"""Batched unit-space scalar operators.

Counterpart of `uptune_tpu/ops/numeric.py`: every operator is an
elementwise function over [B, D] float32 unit lanes, with complex lanes
(bool / switch / enum) handled by masks.  The random numbers each
operator needs are arguments (draw them with `rng.uniform` /
`rng.normal` on a stream of the engine's key); the functions themselves
are pure, so the parity tests can pass in the numbers JAX drew.

`jnp.mod` and `torch.remainder` both take the sign of the divisor, and
`jnp.clip(x, lo, hi)` is `minimum(maximum(x, lo), hi)` as
`torch.clamp` is; the arithmetic below keeps the JAX package's order so
results agree bitwise on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def reflect_unit(v: torch.Tensor) -> torch.Tensor:
    """Reflect out-of-range values into [0, 1] like op1_normal_mutation:
    negatives flip sign, values > 1 map to 1 - (v mod 1)."""
    v = torch.abs(v)
    return torch.where(v > 1.0, 1.0 - torch.remainder(v, 1.0), v)


def randomize(u: torch.Tensor, r: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform redraw of (masked) lanes — op1_randomize; `r` is U[0,1)
    with u's shape."""
    if mask is None:
        return r
    return torch.where(mask, r, u)


def normal_mutation(u: torch.Tensor, sigma: float,
                    complex_mask: torch.Tensor, noise: torch.Tensor,
                    redraw: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """op1_normal_mutation on primitive lanes (`noise` ~ N(0,1)), uniform
    `redraw` on complex lanes; `mask` selects which lanes mutate."""
    noisy = reflect_unit(u + sigma * noise)
    out = torch.where(complex_mask, redraw, noisy)
    if mask is None:
        return out
    return torch.where(mask, out, u)


def set_linear(ua: torch.Tensor, ub: torch.Tensor, uc: torch.Tensor,
               a, b, c, complex_mask: torch.Tensor,
               codes_equal_bc: torch.Tensor, redraw: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a*ua + b*ub + c*uc clipped to [0, 1] on primitive lanes
    (op4_set_linear); on complex lanes copy ua and take `redraw` only
    where ub's and uc's decoded codes differ.  Unmasked lanes keep `base`
    (default ua)."""
    if base is None:
        base = ua
    lin = torch.clamp(a * ua + b * ub + c * uc, 0.0, 1.0)
    cplx = torch.where(codes_equal_bc, ua, redraw)
    out = torch.where(complex_mask, cplx, lin)
    if mask is None:
        return out
    return torch.where(mask, out, base)


def scale(u: torch.Tensor, k: float) -> torch.Tensor:
    """op1_scale in unit space."""
    return torch.clamp(u * k, 0.0, 1.0)


def swarm(u: torch.Tensor, u_local: torch.Tensor, u_global: torch.Tensor,
          velocity: torch.Tensor, complex_mask: torch.Tensor,
          bool_mask: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
          coin: torch.Tensor, pick: torch.Tensor, c: float = 1.0,
          c1: float = 0.5, c2: float = 0.5
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PSO position/velocity update per lane (op3_swarm); r1, r2,
    coin and pick are U[0,1) draws with u's shape.  Returns (new_u,
    new_velocity)."""
    v = velocity * c + (u_local - u) * c1 * r1 + (u_global - u) * c2 * r2
    prim = torch.clamp(u + v, 0.0, 1.0)
    boolean = (torch.sigmoid(v) - coin > 0).to(u.dtype)
    total = c + c1 + c2
    p = pick * total
    mixed = torch.where(p < c, u, torch.where(p < c + c1, u_local, u_global))
    cplx = torch.where(bool_mask, boolean, mixed)
    return torch.where(complex_mask, cplx, prim), v
