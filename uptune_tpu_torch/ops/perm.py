"""Batched permutation operators over [B, n] blocks of item indices.

Counterpart of `uptune_tpu/ops/perm.py`.  The JAX package writes each op
for one permutation and vmaps it with per-row keys; here each op works on
the whole [B, n] batch at once.  Every stochastic op is split in two:

* `draw_<op>(gen, ...)` draws the random numbers for all rows;
* `<op>_batch(pm, <draws>)` is a pure function of the batch and draws.

The parity tests feed the pure part the numbers `jax.random` drew for the
JAX op.  The crossovers (PX/PMX/CX/OX1/OX3) draw their cut points (or the
CX start) per row and take them with the block size `d` as
`cross_<op>_batch(p1, p2, d, draws)`; `CROSSOVERS[name]` pairs each draw
step with its pure function.  The JAX package's sequential walks (PMX's
mapping chase, CX's cycle) are `lax.fori_loop`s; here they are loops of
a fixed count (d and n) of batched gathers, with nothing read on the
host.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

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


# -- crossovers (op3_cross_PX / PMX / CX / OX1 / OX3) ---------------------
def _cut_len(d: int, n: int) -> int:
    return max(1, min(int(d), n))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, j]] for [B, n] x and [B, m] idx."""
    return torch.gather(x, 1, idx)


def draw_cross_px(gen: rng.Stream, rows: int, n: int,
                  d: int = 0) -> torch.Tensor:
    """[rows] int64 cuts in [2, n]."""
    return rng.randint(gen, (rows,), 2, n + 1)


def cross_px_batch(p1: torch.Tensor, p2: torch.Tensor, d: int,
                   c: torch.Tensor) -> torch.Tensor:
    """Partition crossover: p1's first c[b] elements reordered by their
    order in p2; the tail keeps p1's order (a stable argsort, as the JAX
    op's)."""
    n = p1.shape[1]
    i = torch.arange(n, device=p1.device)[None, :]
    key = torch.where(i < c.to(torch.int64)[:, None], _take(_inv(p2), p1),
                      n + i)
    return _take(p1, torch.argsort(key, dim=1, stable=True))


def draw_cross_pmx(gen: rng.Stream, rows: int, n: int,
                   d: int) -> torch.Tensor:
    """[rows] int64 window starts in [0, n - d + 1)."""
    return rng.randint(gen, (rows,), 0, n - _cut_len(d, n) + 1)


def cross_pmx_batch(p1: torch.Tensor, p2: torch.Tensor, d: int,
                    r: torch.Tensor) -> torch.Tensor:
    """Partially-mapped crossover: p2's window [r, r+d) copied into p1;
    a value displaced outside the window follows the window's p2 -> p1
    mapping until it lands on a value not in the window (at most d
    steps: a chase of exactly d steps, each a pair of gathers)."""
    n = p1.shape[1]
    d = _cut_len(d, n)
    pos2 = _inv(p2)
    r = r.to(torch.int64)[:, None]
    i = torch.arange(n, device=p1.device)[None, :]
    in_win = (i >= r) & (i < r + d)
    v = p1
    for _ in range(d):
        at = _take(pos2, v)                     # position of v in p2
        in_seg = (at >= r) & (at < r + d)
        v = torch.where(in_seg, _take(p1, at), v)
    return torch.where(in_win, p2, v)


def draw_cross_cx(gen: rng.Stream, rows: int, n: int,
                  d: int = 0) -> torch.Tensor:
    """[rows] int64 cycle starts in [0, n)."""
    return rng.randint(gen, (rows,), 0, n)


def cross_cx_batch(p1: torch.Tensor, p2: torch.Tensor, d: int,
                   s: torch.Tensor) -> torch.Tensor:
    """Cyclic crossover: walk the cycle i -> pos2[p1[i]] from s[b] (n
    steps, the walk standing still once it closes), then take p2's
    values on the cycle and p1's elsewhere."""
    n = p1.shape[1]
    step = _take(_inv(p2), p1)                  # i -> pos2[p1[i]]
    s = s.to(torch.int64)[:, None]
    cols = torch.arange(n, device=p1.device)[None, :]
    i = s
    on = torch.zeros_like(p1, dtype=torch.bool)
    done = torch.zeros_like(s, dtype=torch.bool)
    for _ in range(n):
        on = on | (cols == i)
        nxt = _take(step, i)
        done = done | (nxt == s)
        i = torch.where(done, i, nxt)
    return torch.where(on, p2, p1)


def draw_cross_ox(gen: rng.Stream, rows: int, n: int, d: int,
                  same_cut: bool) -> torch.Tensor:
    """[rows, 2] int64 (r1, r2): the insertion point in p1's remainder
    and p2's window start, both in [0, n - d + 1); r1 = r2 with
    `same_cut` (OX1)."""
    hi = n - _cut_len(d, n) + 1
    r2 = rng.randint(gen, (rows,), 0, hi)
    r1 = r2 if same_cut else rng.randint(gen, (rows,), 0, hi)
    return torch.stack([r1, r2], dim=1)


def _ox_batch(p1: torch.Tensor, p2: torch.Tensor, d: int,
              cuts: torch.Tensor) -> torch.Tensor:
    """OX1/OX3: p2's window [r2, r2+d) inserted at position r1 of the
    sequence of p1's remaining elements in p1-order."""
    n = p1.shape[1]
    d = _cut_len(d, n)
    cuts = cuts.to(torch.int64)
    r1, r2 = cuts[:, :1], cuts[:, 1:]
    pos2 = _inv(p2)
    seg_of = (pos2 >= r2) & (pos2 < r2 + d)     # by item
    at2 = _take(pos2, p1)
    keep = ~_take(seg_of.to(torch.int64), p1).to(torch.bool)
    rem_rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    out_keep = torch.where(rem_rank < r1, rem_rank, rem_rank + d)
    out_idx = torch.where(keep, out_keep, r1 + (at2 - r2))
    return torch.zeros_like(p1).scatter(1, out_idx, p1)


def draw_cross_ox1(gen: rng.Stream, rows: int, n: int,
                   d: int) -> torch.Tensor:
    return draw_cross_ox(gen, rows, n, d, same_cut=True)


def draw_cross_ox3(gen: rng.Stream, rows: int, n: int,
                   d: int) -> torch.Tensor:
    return draw_cross_ox(gen, rows, n, d, same_cut=False)


def cross_ox1_batch(p1: torch.Tensor, p2: torch.Tensor, d: int,
                    cuts: torch.Tensor) -> torch.Tensor:
    """Ordered crossover (Davis 1985): one shared cut."""
    return _ox_batch(p1, p2, d, cuts)


def cross_ox3_batch(p1: torch.Tensor, p2: torch.Tensor, d: int,
                    cuts: torch.Tensor) -> torch.Tensor:
    """Ordered crossover v3 (Deep 2010): independent cuts."""
    return _ox_batch(p1, p2, d, cuts)


class Crossover(NamedTuple):
    """A crossover's draw step, `draw(gen, rows, n, d)`, and its pure
    function, `apply(p1, p2, d, draws)`."""
    draw: Callable[..., torch.Tensor]
    apply: Callable[..., torch.Tensor]


CROSSOVERS: Dict[str, Crossover] = {
    "PX": Crossover(draw_cross_px, cross_px_batch),
    "PMX": Crossover(draw_cross_pmx, cross_pmx_batch),
    "CX": Crossover(draw_cross_cx, cross_cx_batch),
    "OX1": Crossover(draw_cross_ox1, cross_ox1_batch),
    "OX3": Crossover(draw_cross_ox3, cross_ox3_batch),
}


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
