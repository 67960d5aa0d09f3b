"""One commit into the deduplicating history, replayed in NumPy from
the configuration's stated semantics.

The history is a table of `cap` rows (h0, h1, qor, age), sorted by h0,
live rows first and empty rows (h0 = h1 = 2^32 - 1, qor +inf, age -1)
after them; a real h0 is clamped to 2^32 - 2.  A commit takes a batch of
rows with their hashes and QoR: a row is novel when no live row and no
earlier row of the batch has its hash.  Past capacity the oldest live
rows go first (smallest age; ties at the threshold age in table order),
then the novel rows, sorted by h0 stably, are merged in, history rows
first on an equal h0, each with age = the commit's step."""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

EMPTY = (1 << 32) - 1


class Table(NamedTuple):
    h0: np.ndarray
    h1: np.ndarray
    qor: np.ndarray
    age: np.ndarray
    n: int
    step: int
    dropped: int


def novel(table: Table, hashes: np.ndarray) -> np.ndarray:
    """[B] bool: no live row and no earlier batch row has the hash."""
    h0 = np.minimum(hashes[:, 0], EMPTY - 1)
    live = table.age >= 0
    known = set(zip(table.h0[live].tolist(), table.h1[live].tolist()))
    seen, out = set(), np.zeros(len(hashes), bool)
    for i, key in enumerate(zip(h0.tolist(), hashes[:, 1].tolist())):
        out[i] = key not in known and key not in seen
        seen.add(key)
    return out


def commit(table: Table, hashes: np.ndarray, qor: np.ndarray,
           is_novel: np.ndarray) -> Table:
    cap = len(table.h0)
    h0n = np.minimum(hashes[is_novel, 0], EMPTY - 1)
    h1n = hashes[is_novel, 1]
    qn = qor[is_novel]
    live = np.nonzero(table.age >= 0)[0]
    total = table.n + len(h0n)
    over = max(0, total - cap)
    keep = np.ones(len(live), bool)
    if over:
        order = np.argsort(table.age[live], kind="stable")
        keep[order[:over]] = False
    kept = live[keep]
    order = np.argsort(h0n, kind="stable")
    rows_h0 = np.concatenate([table.h0[kept], h0n[order]])
    rows_h1 = np.concatenate([table.h1[kept], h1n[order]])
    rows_q = np.concatenate([table.qor[kept], qn[order]])
    rows_a = np.concatenate([table.age[kept],
                             np.full(len(h0n), table.step, np.int64)])
    # stable by h0: history rows come first on an equal h0
    m = np.argsort(rows_h0, kind="stable")
    n = min(total, cap)
    out = Table(np.full(cap, EMPTY, np.int64), np.full(cap, EMPTY, np.int64),
                np.full(cap, np.inf), np.full(cap, -1, np.int64), n,
                table.step + 1, table.dropped + over)
    out.h0[:n], out.h1[:n] = rows_h0[m][:n], rows_h1[m][:n]
    out.qor[:n], out.age[:n] = rows_q[m][:n], rows_a[m][:n]
    return out


def mismatches(want: Table, got: Table) -> Dict[str, int]:
    """Rows whose h0, h1 or age differ, and the counters that differ."""
    rows = int(((want.h0 != got.h0) | (want.h1 != got.h1)
                | (want.age != got.age)).sum())
    return {"rows": rows, "n": int(want.n != got.n),
            "step": int(want.step != got.step),
            "dropped": int(want.dropped != got.dropped)}
