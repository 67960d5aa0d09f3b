"""MLP-ensemble surrogate, in torch.

Counterpart of `uptune_tpu/surrogate/mlp.py`: E independently initialised
regressors (F -> width -> width -> 1, GELU in its tanh approximation, as
`jax.nn.gelu` defaults to) trained together by full-batch Adam, whose
disagreement doubles as an uncertainty signal.  Where the JAX package
vmaps one member's program, the port keeps the E members as one set of
stacked parameters (weights [E, din, dout], biases [E, dout]), so every
product is a batched one and one autograd pass gives every member's
gradient (the members' losses are summed; no term couples two members).

Adam is written out as the reference writes it: betas 0.9 / 0.999, eps
1e-8, bias correction 1 - beta^t with t from 1.  The products run in full
float32 (`gp.full_f32`) whatever the caller has set.

Randomness: `draw_init(gen, sizes, n_members)` draws one standard normal
block per layer ([E, din, dout]); `fit` is a pure function of those
draws, so the tests feed it the normals `jax.random` drew.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import rng
from .gp import full_f32


class MLPEnsembleState(NamedTuple):
    params: Tuple             # ((w [E, din, dout], b [E, dout]), ...)
    x_mean: torch.Tensor      # [F]
    x_std: torch.Tensor       # [F]
    y_mean: torch.Tensor
    y_std: torch.Tensor


def layer_sizes(n_features: int, width: int = 64) -> Tuple[int, ...]:
    return (n_features, width, width, 1)


def draw_init(gen: rng.Stream, sizes: Sequence[int],
              n_members: int) -> Tuple[torch.Tensor, ...]:
    """The init's draws: per layer one [E, din, dout] standard normal
    block."""
    return tuple(rng.normal(gen, (n_members, din, dout))
                 for din, dout in zip(sizes[:-1], sizes[1:]))


def init_params(draws: Sequence[torch.Tensor]) -> Tuple:
    """He-scaled weights (normal * sqrt(2 / din), the scale rounded as
    `jnp.sqrt` of a float32 gives it) and zero biases."""
    out = []
    for z in draws:
        scale = torch.sqrt(torch.tensor(2.0 / z.shape[1],
                                        dtype=torch.float32))
        out.append((z * scale.to(z.device),
                    torch.zeros((z.shape[0], z.shape[2]), device=z.device)))
    return tuple(out)


def _forward(params, x: torch.Tensor) -> torch.Tensor:
    """[N, F] -> [E, N] through every member."""
    for i, (w, b) in enumerate(params):
        x = torch.matmul(x, w) + b[:, None, :]
        if i < len(params) - 1:
            x = F.gelu(x, approximate="tanh")
    return x[..., 0]


def _member_losses(params, xn: torch.Tensor, yn: torch.Tensor,
                   w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """[E] each member's weighted mean squared error."""
    return (w * (_forward(params, xn) - yn) ** 2).sum(-1) / n


def _pairs(flat):
    return tuple(zip(flat[0::2], flat[1::2]))


def _bias_correction(beta: float, t: int) -> float:
    """1 - beta^t in float32."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


@full_f32()
def fit(init: Sequence[torch.Tensor], x: torch.Tensor, y: torch.Tensor,
        n_members: int = 4, width: int = 64, steps: int = 300,
        lr: float = 3e-3, mask: Optional[torch.Tensor] = None
        ) -> MLPEnsembleState:
    """Train the ensemble from its init draws (`draw_init`) by full-batch
    Adam.  `mask` ([N] 1.0 real, 0.0 padding) weights the loss and the
    normalisation, so a training set padded to a bucket fits as the
    unpadded one does."""
    sizes = layer_sizes(x.shape[1], width)
    shapes = [(n_members, din, dout) for din, dout in zip(sizes[:-1],
                                                          sizes[1:])]
    if [tuple(z.shape) for z in init] != shapes:
        raise ValueError(f"init draws {[tuple(z.shape) for z in init]} do "
                         f"not match the layers {shapes}")
    w = torch.ones(x.shape[0], device=x.device) if mask is None else mask
    finite = torch.isfinite(y) & (w > 0)     # padding rows are not data
    worst = torch.max(torch.where(finite, y, -math.inf))
    y = torch.where(finite, y, worst)
    n = torch.clamp_min(w.sum(), 1.0)
    x_mean = (x * w[:, None]).sum(0) / n
    x_std = torch.clamp_min(
        torch.sqrt((w[:, None] * (x - x_mean) ** 2).sum(0) / n), 1e-8)
    y_mean = (y * w).sum() / n
    y_std = torch.clamp_min(torch.sqrt((w * (y - y_mean) ** 2).sum() / n),
                            1e-8)
    xn = (x - x_mean) / x_std
    yn = (y - y_mean) / y_std

    params = [t.clone().requires_grad_(True)
              for pair in init_params(init) for t in pair]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for i in range(steps):
        # the members' losses summed: the gradient of member e's
        # parameters is its own loss's
        loss = _member_losses(_pairs(params), xn, yn, w, n).sum()
        g = torch.autograd.grad(loss, params)
        with torch.no_grad():
            m = torch._foreach_add(torch._foreach_mul(m, 0.9),
                                   torch._foreach_mul(g, 0.1))
            v = torch._foreach_add(
                torch._foreach_mul(v, 0.999),
                torch._foreach_mul(torch._foreach_mul(g, 0.001), g))
            mh = torch._foreach_div(m, _bias_correction(0.9, i + 1))
            vh = torch._foreach_div(v, _bias_correction(0.999, i + 1))
            den = torch._foreach_add(torch._foreach_sqrt(vh), 1e-8)
            step = torch._foreach_div(torch._foreach_mul(mh, lr), den)
            params = [p.detach().sub(s).requires_grad_(True)
                      for p, s in zip(params, step)]
    params = _pairs([p.detach() for p in params])
    return MLPEnsembleState(params, x_mean, x_std, y_mean, y_std)


@full_f32()
def predict_members(state: MLPEnsembleState,
                    xq: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [E, B] per-member predictions in target units."""
    xn = (xq - state.x_mean) / state.x_std
    return _forward(state.params, xn) * state.y_std + state.y_mean


def predict(state: MLPEnsembleState,
            xq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, F] -> (member mean [B], member std [B])."""
    preds = predict_members(state, xq)
    return preds.mean(0), preds.std(0, correction=0)
