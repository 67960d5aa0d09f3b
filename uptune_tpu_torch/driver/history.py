"""Device-resident evaluation history: dedup membership + QoR lookup.

Counterpart of `uptune_tpu/driver/history.py`.  The history is an
h0-sorted table of (h0, h1, qor, age) rows on the device; membership and
known-QoR lookup are one `searchsorted` plus a short window compare over
the whole candidate batch, and insertion is a true merge of the sorted
history with the sorted batch (`ops/dedup.py`, a CUDA kernel on the card).

uint32: the JAX package keeps h0/h1 as uint32 with the empty-slot
sentinel 0xFFFFFFFF.  Here each is an int64 holding the u32 value, so
`searchsorted` and the sorts order them as unsigned (a reinterpreted
int32 would put every value >= 2^31 first).  Real h0 values are clamped
to 0xFFFFFFFE so sentinel rows sort last.

Invariant: h0 ascending with equal-h0 runs contiguous, live rows first,
sentinel rows (age -1, qor +inf) after them.  Past capacity, eviction is
oldest-first (smallest insert step), ties at the threshold age in hash
order; evicted live rows accumulate in `dropped`.

The transforms return new tensors; nothing is updated in place (the JAX
package donates its buffers instead — here the caller rebinds and the
caching allocator reuses the old state's memory).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops import dedup as dedup_ops

SENTINEL = 0xFFFFFFFF
# equal-h0 neighbours scanned on lookup (h0 collisions of distinct configs
# are ~n^2/2^33 over a run)
_WINDOW = 8


class HistState(NamedTuple):
    h0: torch.Tensor       # [cap] i64 (u32 values), ascending, sentinel-padded
    h1: torch.Tensor       # [cap] i64 (u32 values)
    qor: torch.Tensor      # [cap] f32
    n: torch.Tensor        # scalar i32: live entries
    age: torch.Tensor      # [cap] i32 insert step per row (-1 = empty)
    step: torch.Tensor     # scalar i32: insert-batch counter
    dropped: torch.Tensor  # scalar i32: live rows evicted past capacity


class History:
    """Static config (capacity, device) + state transforms."""

    def __init__(self, capacity: int = 1 << 16, device: DeviceLike = "cuda"):
        self.capacity = int(capacity)
        self.device = resolve_device(device)

    def init(self) -> HistState:
        cap, dev = self.capacity, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        return HistState(
            torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev),
            torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev),
            torch.full((cap,), float("inf"), dtype=torch.float32,
                       device=dev),
            torch.zeros((), **i32),
            torch.full((cap,), -1, **i32),
            torch.zeros((), **i32),
            torch.zeros((), **i32))

    @staticmethod
    def _clamp(hashes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return torch.clamp_max(hashes[:, 0], SENTINEL - 1), hashes[:, 1]

    def contains(self, st: HistState, hashes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """hashes [B, 2] -> (found [B] bool, known_qor [B] f32, +inf when
        absent)."""
        h0, h1 = self._clamp(hashes)
        idx = torch.searchsorted(st.h0, h0, right=False)
        found = torch.zeros(h0.shape, dtype=torch.bool, device=h0.device)
        qor = torch.full(h0.shape, float("inf"), dtype=torch.float32,
                         device=h0.device)
        cap = self.capacity
        for j in range(_WINDOW):
            pos = torch.clamp_max(idx + j, cap - 1)
            hit = (st.h0[pos] == h0) & (st.h1[pos] == h1) & ~found
            qor = torch.where(hit, st.qor[pos], qor)
            found = found | hit
        return found, qor

    def _evict(self, h0, h1, q, age, k):
        """Drop the k oldest live rows (ties at the threshold age drop in
        hash order) and compact the kept rows to the front, which keeps
        them h0-sorted.  `k` is a 0-dim device tensor.

        At k == 0 this is the identity on a table that holds the
        invariant: every live row is kept and the sentinel rows follow.
        The JAX package runs it under `lax.cond(overflow > 0)`; here it
        runs on every insert, because reading `overflow > 0` on the host
        would stall the launch queue once per step, and at the engine's
        sizes (a 2^15-row history, ~6k rows a step) the history is full
        after a few steps and overflows on every step after that anyway.

        The threshold is the k-th smallest live age.  The JAX package
        finds it with a 31-round binary search (compare-and-count passes
        suit the TPU); here it is one sort and a device-side index (no
        host read of k).  For k == 0 the index clamps to the smallest live
        age, which drops nothing, as the JAX threshold 0 does."""
        cap = self.capacity
        live = age >= 0
        big = torch.iinfo(torch.int32).max
        ages_live = torch.where(live, age, big)
        srt = torch.sort(ages_live).values
        kk = torch.clamp_min(k.to(torch.int64) - 1, 0).reshape(1)
        thr = srt.index_select(0, kk).reshape(())
        drop_lt = live & (age < thr)
        eq = live & (age == thr)
        m = k - drop_lt.sum().to(torch.int32)
        drop_eq = eq & (torch.cumsum(eq.to(torch.int32), 0) <= m)
        keep = live & ~(drop_lt | drop_eq)
        # output slot j pulls the row where the keep-cumsum first reaches
        # j+1; slots past the kept count read the sentinel row
        cum = torch.cumsum(keep.to(torch.int32), 0)
        src = torch.searchsorted(
            cum, torch.arange(1, cap + 1, device=cum.device,
                              dtype=cum.dtype), right=False)
        ok = torch.arange(cap, device=cum.device) < cum[-1]
        src = torch.clamp(src, 0, cap - 1)
        return (torch.where(ok, h0[src], SENTINEL),
                torch.where(ok, h1[src], SENTINEL),
                torch.where(ok, q[src], float("inf")),
                torch.where(ok, age[src], -1))

    def insert(self, st: HistState, hashes: torch.Tensor, qor: torch.Tensor,
               valid: torch.Tensor) -> HistState:
        """Merge the batch rows where `valid` is True.  Overflow past
        capacity evicts the oldest live rows first; their count
        accumulates in `dropped`.

        Pipeline: evict-and-compact the history (see `_evict`), sort only
        the b-row batch (stable, as `lax.sort` with one key is), then the
        stable two-run merge (`ops/dedup.py`)."""
        cap = self.capacity
        h0n, h1n = self._clamp(hashes)
        h0n = torch.where(valid, h0n, SENTINEL)
        h1n = torch.where(valid, h1n, SENTINEL)
        age_n = torch.where(valid, st.step, -1).to(torch.int32)
        qn = torch.where(valid, qor.to(torch.float32), float("inf"))

        n_new = valid.sum().to(torch.int32)
        total = st.n + n_new
        overflow = torch.clamp_min(total - cap, 0)
        h0h, h1h, qh, ah = self._evict(st.h0, st.h1, st.qor, st.age,
                                       overflow)

        order = torch.sort(h0n, stable=True).indices
        h0m, h1m, qm, am = dedup_ops.merge_history(
            (h0h, h1h, qh, ah),
            (h0n[order], h1n[order], qn[order], age_n[order]))
        return HistState(h0m, h1m, qm, torch.clamp_max(total, cap), am,
                         st.step + 1, st.dropped + overflow)


def unique_mask(hashes: torch.Tensor) -> torch.Tensor:
    """[B, 2] -> [B] bool marking the FIRST occurrence of each distinct
    hash within the batch."""
    return dup_source(hashes) == torch.arange(hashes.shape[0],
                                              device=hashes.device)


def dup_source(hashes: torch.Tensor) -> torch.Tensor:
    """[B, 2] -> [B] int32: index of the first in-batch occurrence of each
    row's hash (i for first occurrences themselves).

    The JAX package sorts on three keys (h0, h1, index) with one
    `lax.sort`; here two stable sorts (h1, then h0) give the same order —
    ties keep index order — and a `cummax` carries each run's head
    forward.  (h0 << 32 | h1 packed into one int64 would overflow the
    sign bit.)"""
    h0, h1 = hashes[:, 0], hashes[:, 1]
    B = h0.shape[0]
    dev = h0.device
    o1 = torch.sort(h1, stable=True).indices
    o2 = torch.sort(h0[o1], stable=True).indices
    osort = o1[o2]
    h0s, h1s = h0[osort], h1[osort]
    is_first = torch.cat([
        torch.ones(min(B, 1), dtype=torch.bool, device=dev),
        (h0s[1:] != h0s[:-1]) | (h1s[1:] != h1s[:-1])])
    ar = torch.arange(B, device=dev)
    head = torch.cummax(torch.where(is_first, ar, 0), dim=0).values
    src_sorted = osort[head].to(torch.int32)
    return torch.zeros_like(src_sorted).scatter(0, osort, src_sorted)
