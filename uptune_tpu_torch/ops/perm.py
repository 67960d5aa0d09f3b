"""Batched permutation operators over [B, n] blocks of item indices.

Counterpart of `uptune_tpu/ops/perm.py`.  The JAX package writes each op
for one permutation and vmaps it with per-row keys; here each op works on
the whole [B, n] batch at once.  Every stochastic op is split in two:

* `draw_<op>(gen, ...)` draws the random numbers for all rows;
* `<op>_batch(pm, <draws>)` is a pure function of the batch and draws.

The parity tests feed the pure part the numbers `jax.random` drew for the
JAX op.  The crossovers (PX/PMX/CX/OX1/OX3) are not ported yet; they come
with a later slice of the port.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import rng


def _inv(pm: torch.Tensor) -> torch.Tensor:
    """[B, n] -> inverse permutations: inv[b, item] = position of item."""
    n = pm.shape[-1]
    pos = torch.arange(n, device=pm.device, dtype=pm.dtype).expand_as(pm)
    return torch.zeros_like(pm).scatter(-1, pm, pos)


# -- shuffle (op1_randomize) ----------------------------------------------
def draw_shuffle(gen: rng.Stream, rows: int, n: int) -> torch.Tensor:
    """[rows, n] int64 index permutations."""
    return rng.permutations(gen, rows, n)


def shuffle_batch(pm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row b becomes pm[b, idx[b]] — `jax.random.permutation(key, p)`
    reorders p by the same index permutation it gives for range(n)."""
    return torch.gather(pm, 1, idx.to(torch.int64))


# -- small random change (op1_small_random_change) -------------------------
def draw_small_random_change(gen: rng.Stream, rows: int,
                             n: int) -> torch.Tensor:
    """[rows, n] f32 uniform coins (column 0 unused)."""
    return rng.uniform(gen, (rows, n))


def small_random_change_batch(pm: torch.Tensor, coins: torch.Tensor,
                              prob: float = 0.25) -> torch.Tensor:
    """Left-to-right adjacent-swap bubble pass: element i-1 swaps with i
    where coins[:, i] < prob, sequentially, so a value can bubble several
    positions right."""
    n = pm.shape[1]
    do_swap = coins < prob
    cols = list(pm.unbind(1))
    for i in range(1, n):
        a, b = cols[i - 1], cols[i]
        sw = do_swap[:, i]
        cols[i - 1] = torch.where(sw, b, a)
        cols[i] = torch.where(sw, a, b)
    return torch.stack(cols, dim=1)


# -- random swap (op2_random_swap) ------------------------------------------
def draw_random_swap(gen: rng.Stream, rows: int,
                     n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two [rows] int64 positions in [0, n) per row."""
    return rng.randint(gen, (rows,), 0, n), rng.randint(gen, (rows,), 0, n)


def random_swap_batch(pm: torch.Tensor, r: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Swap positions r[b] and s[b] of each row."""
    r, s = r.to(torch.int64)[:, None], s.to(torch.int64)[:, None]
    pr, ps = torch.gather(pm, 1, r), torch.gather(pm, 1, s)
    i = torch.arange(pm.shape[1], device=pm.device)[None, :]
    return torch.where(i == s, pr, torch.where(i == r, ps, pm))


# -- random invert (op2_random_invert) --------------------------------------
def _invert_len(d: int, n: int) -> int:
    return max(1, min(int(d), n))


def draw_random_invert(gen: rng.Stream, rows: int, n: int,
                       d: int) -> torch.Tensor:
    """[rows] int64 window starts in [0, n - d + 1)."""
    return rng.randint(gen, (rows,), 0, n - _invert_len(d, n) + 1)


def random_invert_batch(pm: torch.Tensor, d: int,
                        r: torch.Tensor) -> torch.Tensor:
    """Reverse the length-d window starting at r[b] of each row."""
    n = pm.shape[1]
    d = _invert_len(d, n)
    i = torch.arange(n, device=pm.device)[None, :]
    r = r.to(torch.int64)[:, None]
    in_win = (i >= r) & (i < r + d)
    src = torch.where(in_win, 2 * r + d - 1 - i, i)
    return torch.gather(pm, 1, src)


# -- topological normalisation (ScheduleParam) -------------------------------
def toposort_batch(pm: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """[B, n] stable topological normalisation: dep[i, j] True means item
    i requires item j earlier.  Emits, n times, the not-yet-emitted item
    with all prerequisites emitted that sits earliest in the row."""
    B, n = pm.shape
    rank = _inv(pm)
    items = torch.arange(n, device=pm.device)[None, :]
    emitted = torch.zeros((B, n), dtype=torch.bool, device=pm.device)
    out = []
    not_dep = ~dep.to(torch.bool)
    for i in range(n):
        ready = (~emitted) & torch.all(not_dep[None] | emitted[:, None, :],
                                       dim=2)
        score = torch.where(ready, rank, n + 1)
        item = torch.argmin(score, dim=1)            # first minimum
        emitted = emitted | (items == item[:, None])
        out.append(item.to(pm.dtype))
    return torch.stack(out, dim=1)
