"""Multi-process scale-out: the `torch.distributed` bootstrap and the
('search', 'eval') mesh across processes.

Counterpart of `uptune_tpu/parallel/multihost.py`.  The reference reaches
several machines through a Ray cluster and a shared filesystem; the JAX
package runs the same program in every process, wires them with
`jax.distributed.initialize`, and lays the ('search', 'eval') mesh of
`parallel/sharded.py` out so that the search axis (the best exchange:
tiny payloads, latency-tolerant) spans the processes while the eval axis
(a replica's batch sharding) stays inside each one.  Here every process
runs the same program too, `initialize` forms a `torch.distributed`
process group, and `make_multihost_mesh` keeps that layout: the eval
axis never crosses a process.

Environment-variable bootstrap mirrors the reference's settings-dict
layering (arguments > env > defaults): UT_COORDINATOR (host:port of rank
0's rendezvous), UT_NUM_PROCESSES, UT_PROCESS_ID — what `ut-torch
--num-hosts N` gives its children.

Backends: NCCL when the ranks are on the card with one card each (at
least as many cards as processes), gloo otherwise — on the CPU, and for
several ranks sharing one card, where NCCL refuses two ranks on one
device; a gloo collective over tensors on the card stages them through
pinned host memory (`parallel/mesh.py`).  `init_process_group` always
gets an explicit timeout, so a rank that never arrives fails the others
in seconds instead of hanging them.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional, Sequence

from .mesh import Mesh, local_devices

DEFAULT_TIMEOUT_S = 120.0


def distributed_config(coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> dict:
    """Resolve the bootstrap triple from args > UT_* env > single-process
    defaults; validates before any network call."""
    coordinator = coordinator or os.environ.get("UT_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("UT_NUM_PROCESSES")
        num_processes = int(env) if env else 1
    if process_id is None:
        env = os.environ.get("UT_PROCESS_ID")
        process_id = int(env) if env else 0
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} outside [0, {num_processes})")
    if num_processes > 1 and not coordinator:
        raise ValueError(
            "multi-process run needs a coordinator address "
            "(UT_COORDINATOR=host:port or coordinator=...)")
    return {"coordinator_address": coordinator,
            "num_processes": num_processes, "process_id": process_id}


def default_backend(num_processes: int) -> str:
    """NCCL when each rank can hold a card of its own, else gloo."""
    import torch
    if torch.cuda.is_available() \
            and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return f"localhost:{port}"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Form the process group of a multi-process run; a no-op for a
    single process unless `backend` asks for a group anyway (a one-rank
    group, whose collectives really run through that backend).  Returns
    the resolved config with the backend used (None without a group).
    A NCCL rank takes card ``process_id % device_count``."""
    cfg = distributed_config(coordinator, num_processes, process_id)
    n, pid = cfg["num_processes"], cfg["process_id"]
    if n == 1 and backend is None:
        return dict(cfg, backend=None)
    import torch
    import torch.distributed as dist
    be = backend or default_backend(n)
    if be == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    addr = cfg["coordinator_address"] or _free_addr()
    dist.init_process_group(be, init_method=f"tcp://{addr}", world_size=n,
                            rank=pid, timeout=timedelta(seconds=timeout))
    return dict(cfg, coordinator_address=addr, backend=be)


def shutdown() -> None:
    """Leave the process group `initialize` formed (if any)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def make_multihost_mesh(n_eval_per_host: int = 1,
                        devices: Optional[Sequence] = None,
                        device="cuda") -> Mesh:
    """('search', 'eval') mesh spanning every process's devices.

    Layout contract: a process's positions are contiguous along the
    search axis and the eval axis never crosses a process, so only the
    (scalar) best exchange crosses processes.  `devices` (default: this
    process's devices of `device`'s type, `local_devices`, as every
    process sees them) is the global list, every rank's in rank order,
    the same length for each; a device may be listed more than once."""
    group, world, _ = _world()
    if devices is None:
        # the eval axis must fit inside one process
        local = local_devices(device)
        if len(local) % n_eval_per_host:
            raise ValueError(
                f"eval width {n_eval_per_host} does not divide the "
                f"{len(local)} local devices — the eval all_gather would "
                f"cross a process boundary")
        devices = local * world
    else:
        devices = list(devices)
    n = len(devices)
    if n % n_eval_per_host:
        raise ValueError(
            f"{n} global devices not divisible by eval width "
            f"{n_eval_per_host}")
    if n % world or (n // world) % n_eval_per_host:
        raise ValueError(
            f"{n} global devices over {world} processes: the eval width "
            f"{n_eval_per_host} does not divide each process's share")
    per = n // world
    ranks = [p // per for p in range(n)]
    shape = (n // n_eval_per_host, n_eval_per_host)
    return Mesh([devices[r * n_eval_per_host:(r + 1) * n_eval_per_host]
                 for r in range(shape[0])], ("search", "eval"),
                group=group,
                ranks=[ranks[r * n_eval_per_host:(r + 1) * n_eval_per_host]
                       for r in range(shape[0])])


def is_coordinator() -> bool:
    """True on the process that should own host-side IO (archive writes,
    best.json, logging) — rank 0, or the only process."""
    return _world()[2] == 0
