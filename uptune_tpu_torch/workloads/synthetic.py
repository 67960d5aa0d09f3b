"""Synthetic benchmark objectives (rosenbrock, sphere, beale, tsp) in
batched form.

Counterpart of `uptune_tpu/workloads/synthetic.py`.  Each objective
provides:

* a space (`rosenbrock_space`, `tsp_space`);
* a device function over decoded values or a permutation block
  (`*_device`), which the fused engine calls;
* a host callable `(list[config dict]) -> np.ndarray` for the `Tuner`
  (`make_host_objective`, `rosenbrock_objective`, `tsp_objective`): the
  configs become one float32 batch on `device` (default ``"cuda"``), the
  device function scores it in one call, and the values come back to the
  host.  The JAX package also scores in float32 (its default precision).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..space.params import FloatParam, IntParam, PermParam
from ..space.spec import Space


def rosenbrock_space(dims: int = 2, lo: float = -30.0, hi: float = 30.0,
                     as_int: bool = False) -> Space:
    mk = IntParam if as_int else FloatParam
    return Space([mk(f"x{i}", lo, hi) for i in range(dims)])


def rosenbrock_device(x: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [...] classic Rosenbrock value."""
    a, b = x[..., :-1], x[..., 1:]
    return (100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2).sum(dim=-1)


def sphere_device(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=-1)


def beale_device(x: torch.Tensor) -> torch.Tensor:
    a, b = x[..., 0], x[..., 1]
    return ((1.5 - a + a * b) ** 2
            + (2.25 - a + a * b ** 2) ** 2
            + (2.625 - a + a * b ** 3) ** 2)


def _configs_to_x(cfgs: List[Dict], dims: int) -> np.ndarray:
    return np.asarray([[c[f"x{i}"] for i in range(dims)] for c in cfgs],
                      np.float64)


def make_host_objective(fn_device, dims: int, device: DeviceLike = "cuda"):
    """configs -> fn_device over their x0..x{dims-1} as one float32 batch
    on `device` -> numpy values."""
    dev = resolve_device(device)

    def objective(cfgs: List[Dict]) -> np.ndarray:
        x = torch.as_tensor(_configs_to_x(cfgs, dims), dtype=torch.float32)
        return fn_device(x.to(dev)).cpu().numpy()
    return objective


def rosenbrock_objective(dims: int = 2, device: DeviceLike = "cuda"):
    return make_host_objective(rosenbrock_device, dims, device)


def tsp_space(n_cities: int) -> Space:
    return Space([PermParam("tour", list(range(n_cities)))])


def random_tsp_distances(n_cities: int, seed: int = 0) -> np.ndarray:
    """[n, n] float64 Euclidean distances between uniform random cities."""
    rs = np.random.RandomState(seed)
    pts = rs.rand(n_cities, 2)
    return np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))


def tsp_device(perm: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """perm [..., N] city order -> [...] closed-tour length."""
    nxt = torch.roll(perm, -1, dims=-1)
    return dist[perm, nxt].sum(dim=-1)


def tsp_objective(dist: np.ndarray, device: DeviceLike = "cuda"):
    """configs -> closed-tour length of their "tour" over `dist` (as
    float32 on `device`) -> numpy values."""
    dev = resolve_device(device)
    dt = torch.as_tensor(np.asarray(dist), dtype=torch.float32).to(dev)

    def objective(cfgs: List[Dict]) -> np.ndarray:
        perm = torch.as_tensor([c["tour"] for c in cfgs], dtype=torch.int64)
        return tsp_device(perm.to(dev), dt).cpu().numpy()
    return objective


# gcc's --param ranges come in a few sizes (g++ 12: booleans, small
# counts, percentages, byte sizes, INT_MAX-wide limits)
_GCC_PARAM_HI = (1, 2, 8, 16, 100, 255, 1000, 65536, 2147483647)


def gcc_like_records(n_flags: int = 232, n_params: int = 95,
                     seed: int = 0) -> List[Dict]:
    """The param records (`ut.params.json`, one stage) of a space shaped
    like `samples/gcc-options/tune_gcc.py`'s over a mined g++ (232 flags
    and 95 params with g++ 12.2), without mining a compiler: `olevel`
    over -O0..-O3, each flag an on / off / default tri-state, each
    param an int range with its default, then `block_size`.  The port's
    Space over them has n_cat = 1 + n_flags (4 codes at most) and
    n_params + 1 numeric lanes: a GP feature width of 96 + 233 x 4 = 1028
    at the defaults."""
    r = np.random.RandomState(seed)
    recs: List[Dict] = [{"name": "olevel", "type": "enum",
                         "default": "-O2",
                         "options": ["-O0", "-O1", "-O2", "-O3"]}]
    for i in range(n_flags):
        recs.append({"name": f"-fflag-{i:03d}", "type": "enum",
                     "default": "default",
                     "options": ["default", "on", "off"]})
    for i in range(n_params):
        lo = int(r.randint(0, 2))
        hi = max(lo + 1, int(_GCC_PARAM_HI[r.randint(len(_GCC_PARAM_HI))]))
        recs.append({"name": f"param-{i:03d}", "type": "int",
                     "default": int(r.randint(lo, min(hi, 1 << 20) + 1)),
                     "lo": lo, "hi": hi})
    recs.append({"name": "block_size", "type": "int", "default": 16,
                 "lo": 4, "hi": 128})
    return recs
