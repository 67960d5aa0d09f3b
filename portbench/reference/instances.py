"""The rules that couple cooperating instances, in plain NumPy, from the
configuration's guarantees (`gcc-options-g12-pf4`'s `guarantees`).

Each instance's own commit is judged by the single-instance reference
(`history.py`, `gcc.py`, `gp.py`); what the instances share is judged
here:

* `fold`: an instance's best after its step, the least of its previous
  best and its batch's QoR (the batch's first least row, the previous
  best kept on a tie);
* `exchange`: the instance whose folded best every instance takes after
  the step, the lexicographic (QoR, instance index) least, or none while
  no folded QoR is finite (each instance then keeps its own);
* `pooled_topk`: the k largest utilities of the instances' pooled
  proposals, descending, ties to the lowest flat index.  The pool is
  read in (instance, row) order; within an instance a tie is ranked to
  its lowest row, so this is the order of (instance, local rank) that
  the guarantee states."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fold(prev: float, q: np.ndarray) -> Tuple[float, int]:
    """(the folded best's QoR, its row in the batch, -1 when the previous
    best is kept)."""
    q = np.asarray(q, np.float64)
    if not len(q):
        return float(prev), -1
    r = int(np.argmin(q))
    return (float(q[r]), r) if q[r] < prev else (float(prev), -1)


def exchange(folded) -> Optional[int]:
    """The instance whose folded best every instance takes, or None."""
    f = np.asarray(folded, np.float64)
    if not np.isfinite(f).any():
        return None
    return int(np.argmin(f))


def pooled_topk(u: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """u [n, B] utilities -> (values [k] descending, owner [k], row [k])."""
    u = np.asarray(u)
    flat = u.reshape(-1)
    order = np.argsort(-flat, kind="stable")[:k]
    return flat[order], order // u.shape[1], order % u.shape[1]


def order_faults(vals: np.ndarray, owner: np.ndarray, row: np.ndarray
                 ) -> int:
    """Neighbours of a returned top-k list out of the pooled order:
    values not descending, or an equal value not at a higher (instance,
    row) than the one before it."""
    v = np.asarray(vals, np.float64)
    o, r = np.asarray(owner, np.int64), np.asarray(row, np.int64)
    down = v[1:] < v[:-1]
    tied_after = (v[1:] == v[:-1]) & ((o[1:] > o[:-1])
                                      | ((o[1:] == o[:-1]) & (r[1:] > r[:-1])))
    return int((~(down | tied_after)).sum())
