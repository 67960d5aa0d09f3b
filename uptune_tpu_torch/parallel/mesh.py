"""Named-axis device meshes and the collectives of the mesh plane.

The JAX package lays its multi-chip paths over a `jax.sharding.Mesh` and
runs them under `shard_map`, whose collectives (`pmin`, `psum`,
`all_gather`, `axis_index`) XLA lowers onto the interconnect.  A mesh
serves two cases there, and the port keeps both:

* one process over several shards (`make_mesh`, `make_instance_mesh`):
  the grid lists devices, and one device may appear more than once (on
  one card, ``cuda:0`` is listed K times).  The shards run one after
  another in this process, and a collective over such a LOCAL axis
  stacks the shards' tensors on the axis's first device;
* several processes (`make_multihost_mesh`): each position of the grid
  belongs to one rank of a `torch.distributed` process group, every
  rank holds the same number of positions, and a rank's positions are
  contiguous in the grid's row-major order.  A collective gathers every
  rank's rows in rank order (`all_gather`), so each rank then computes
  the same reduction (the exchange's lexicographic argmin, the one-hot
  sum) from the same rows, as `pmin` / `psum` do.

The port runs each process on one device, PyTorch's idiom: several cards
are several processes (one rank a card, NCCL between them), never one
process driving several cards.  Gloo takes only host tensors, so a gloo
collective over tensors on the card copies them explicitly into pinned
host memory and back; `staging()` counts those copies.  That is the
route (a one-card group of several ranks has no other), and the callers
print it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "all_gather", "canonical", "gather_local",
           "local_devices", "staging",
           "reset_staging", "leaves", "stack_trees", "unstack_tree"]

# the collectives run through a process group, the host seconds spent in
# them, and the copies the gloo route made between the card and pinned
# host memory
_STAGING = {"to_host": 0, "to_device": 0, "bytes": 0, "collectives": 0,
            "seconds": 0.0}


def staging() -> Dict[str, float]:
    """The collectives run through a process group, the host seconds in
    them, and the host copies (count and bytes each way) that gloo forced
    for tensors on the card."""
    return dict(_STAGING)


def reset_staging() -> None:
    for k in _STAGING:
        _STAGING[k] = 0.0 if k == "seconds" else 0


def local_devices(device="cuda") -> List[torch.device]:
    """This process's devices of `device`'s type: every card it sees, or
    the one CPU device."""
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def canonical(device) -> torch.device:
    """`device` with its index: ``cuda`` is the current card's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Axis names over a grid of `torch.device`s, the rank that owns each
    position and the process group (None: this process owns every
    position, the local case)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 group=None, ranks=None):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for at in np.ndindex(given.shape):
            grid[at] = torch.device(given[at])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {axis_names!r}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.group = group
        self.ranks = (np.zeros(grid.shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(
                          grid.shape))
        if group is None:
            self.rank, self.world = 0, 1
            if self.ranks.any():
                raise ValueError("a mesh without a process group is one "
                                 "process's: every position is rank 0's")
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks={self.world}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")

    def axis(self, name: str) -> int:
        return self.axis_names.index(name)

    def owned(self, name: str) -> List[int]:
        """The positions along axis `name` this process holds, at its
        first position on the other axes."""
        ax = self.axis(name)
        mine = np.argwhere(self.ranks == self.rank)
        if not len(mine):
            return []
        at = list(mine[0])
        out = []
        for i in range(self.devices.shape[ax]):
            at[ax] = i
            if self.ranks[tuple(at)] == self.rank:
                out.append(i)
        return out

    def spans_processes(self, name: str) -> bool:
        """True when axis `name`'s positions belong to more than one
        rank (its collectives go through the process group)."""
        return len(self.owned(name)) < self.shape[name]

    def device_of(self, name: str, i: int) -> torch.device:
        """The device at position i of axis `name` (the other axes at
        this process's first position)."""
        ax = self.axis(name)
        at = list(np.argwhere(self.ranks == self.rank)[0])
        at[ax] = i
        return self.devices[tuple(at)]

    def backend(self) -> Optional[str]:
        if self.group is None:
            return None
        import torch.distributed as dist
        return dist.get_backend(self.group)


def gather_local(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The collective over a local axis: the shards' tensors (each with
    the shard's rows first) stacked on the first shard's device."""
    dev = tensors[0].device
    return torch.cat([t.to(dev) for t in tensors])


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[n_own, ...] rows this process holds -> [n_own * world, ...] every
    rank's rows in rank order (the grid's order along an axis that spans
    the processes).  Without a process group, `x` itself."""
    if mesh.group is None:
        return x
    t0 = time.perf_counter()
    try:
        return _all_gather(mesh, x)
    finally:
        _STAGING["collectives"] += 1
        _STAGING["seconds"] += time.perf_counter() - t0


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist
    world = mesh.world
    if mesh.backend() == "nccl":
        out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out
    # gloo: host tensors only; bool travels as uint8
    send = x.to(torch.uint8) if x.dtype == torch.bool else x
    on_card = send.device.type == "cuda"
    if on_card:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host.copy_(send)
        _STAGING["to_host"] += 1
        _STAGING["bytes"] += host.numel() * host.element_size()
    else:
        host = send.contiguous()
    out = torch.empty((world * host.shape[0],) + tuple(host.shape[1:]),
                      dtype=host.dtype, pin_memory=on_card)
    dist.all_gather(list(out.chunk(world)), host, group=mesh.group)
    if on_card:
        out = out.to(x.device, non_blocking=True)
        _STAGING["to_device"] += 1
        _STAGING["bytes"] += out.numel() * out.element_size()
    return out.to(torch.bool) if x.dtype == torch.bool else out


# -- trees of NamedTuples and tuples (engine states) ---------------------------
def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_map(fn, x) for x in tree)
    return tree


def leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map(out.append, tree)
    return out


def stack_trees(trees: Sequence, cat: bool = False):
    """One tree whose leaves stack (or, with `cat`, concatenate) the
    trees' leaves along a new (an existing) leading axis."""
    cols = zip(*(leaves(t) for t in trees))
    join = torch.cat if cat else torch.stack
    it = iter([join(list(c)) for c in cols])
    return _map(lambda _: next(it), trees[0])


def unstack_tree(tree, n: int, chunks: Optional[int] = None) -> list:
    """The n rows of a stacked tree (views), or with `chunks` its n
    contiguous blocks of rows."""
    if chunks is None:
        return [_map(lambda t: t[i], tree) for i in range(n)]
    return [_map(lambda t: t[i * chunks:(i + 1) * chunks], tree)
            for i in range(n)]
