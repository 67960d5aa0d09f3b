#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`uptune_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py              # the full check (one card)
    python3 chip_smoke.py --profile    # also a torch.profiler window

It imports nothing of JAX or of the JAX package.  Phases, each printing
one JSON line:

1. device  - the card (nvidia-smi name and power limit), torch and CUDA;
2. build   - every kernel of the port, built with nvcc from csrc/;
3. merge   - the merge kernel against its plain version on the card, at
             cap 2^15 / b 6040 (half-full and full history) and cap 2048 /
             b 2048, all four columns bitwise; kernel, plain and library
             times (CUDA events, median of 50 runs after warm-up);
4. engine  - the flagship at scale 64 (6040 rows a step, a 2^15-row
             history): init, one warm step, then the timed steps with the
             launch counts set to 0 just before and read just after; one
             merge launch per commit, a finite best, valid permutations;
5. reference - one commit of that engine's state on the card and on the
             CPU (plain versions) from the same inputs: the whole state
             bitwise equal;
6. kernels - one entry per kernel: launches on the main path, error
             against the plain version, times and bound.

The line before the last is `nvidia-smi --query-gpu=name,power.limit`;
the last is `{"ok": true, "device": {...}}`.  Any failure raises, so the
script exits non-zero and prints no `ok` line; so does a host without a
card or a directory without the package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM, NVIDIA's data sheet: 3.35 TB/s of HBM3
HBM_BYTES_PER_S = 3.35e12
REPS = 50
# the engine run: the flagship at the size of the JAX package's TPU
# headline (bench.py), 6040 rows a step into a 2^15-row history
SCALE, CAPACITY, STEPS, SEED = 64, 1 << 15, 200, 0
SIZES = (  # (name, cap, b, live history rows)
    ("cap32768_b6040_half", 1 << 15, 6040, 1 << 14),
    ("cap32768_b6040_full", 1 << 15, 6040, 1 << 15),
    ("cap2048_b2048", 2048, 2048, 2000),
)
TIMED = "cap32768_b6040_full"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()


# -- timing -------------------------------------------------------------------
def median_ms(fn, reps: int = REPS, per_rep: int = 10) -> float:
    """Device time of one call: CUDA events around `per_rep` calls
    captured in a CUDA graph (so host launch overhead is not timed),
    median over `reps` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_rep):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs) / per_rep


def call_ms(fn, reps: int = REPS, per_rep: int = 10) -> float:
    """Time of one eager call as the engine makes it, host launch
    included: CUDA events around `per_rep` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_rep):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs) / per_rep


# -- the merge kernel against its plain version --------------------------------
def merge_inputs(cap: int, b: int, n_live: int, seed: int, dev):
    """An h0-sorted history with n_live live rows, an h0-sorted batch with
    history collisions and sentinel rows, and the merge positions."""
    import numpy as np
    from uptune_tpu_torch.driver.history import SENTINEL
    rng = np.random.RandomState(seed)
    h0 = np.sort(rng.randint(0, 2**32 - 1, n_live)).astype(np.int64)
    h0 = np.concatenate([h0, np.full(cap - n_live, SENTINEL, np.int64)])
    h1 = rng.randint(0, 2**32, cap).astype(np.int64)
    q = rng.randn(cap).astype(np.float32)
    q[n_live:] = np.inf
    age = np.concatenate([rng.randint(0, 50, n_live),
                          np.full(cap - n_live, -1)]).astype(np.int32)
    nh0 = rng.randint(0, 2**32 - 1, b).astype(np.int64)
    nh0[:b // 8] = h0[rng.randint(0, max(1, n_live), b // 8)]  # collisions
    nh0[-b // 16:] = SENTINEL                                   # invalid rows
    nh0 = np.sort(nh0)
    new = (nh0, rng.randint(0, 2**32, b).astype(np.int64),
           rng.randn(b).astype(np.float32), np.full(b, 50, np.int32))

    def put(cols):
        return tuple(torch.from_numpy(c).to(dev) for c in cols)
    hist, new = put((h0, h1, q, age)), put(new)
    pos = (torch.arange(b, device=dev)
           + torch.searchsorted(hist[0], new[0], right=True)).to(torch.int32)
    return hist, new, pos


def library_merge(hist, new):
    """The same merge as one stable torch.sort plus gathers: the yardstick
    (`library_ms`), never called by the port."""
    cap = hist[0].shape[0]
    order = torch.sort(torch.cat([hist[0], new[0]]), stable=True).indices[:cap]
    return tuple(torch.cat([h, n])[order] for h, n in zip(hist, new))


def col_bits(t: torch.Tensor) -> torch.Tensor:
    return (t.view(torch.int32) if t.dtype == torch.float32 else t).to(
        torch.int64)


def max_bit_err(a, b) -> int:
    """The largest |a - b| over the four columns, qor as its bit pattern
    (0 iff the merges are bitwise equal)."""
    return max(int((col_bits(x) - col_bits(y)).abs().max()) for x, y in zip(a, b))


def merge_phase(dev) -> dict:
    from uptune_tpu_torch.ops import dedup
    out = {"phase": "merge", "tolerance": "bitwise", "cases": []}
    timed = None
    for i, (name, cap, b, n_live) in enumerate(SIZES):
        hist, new, pos = merge_inputs(cap, b, n_live, 100 + i, dev)
        got = dedup.merge_rows_cuda(hist, new, pos)
        want = dedup.merge_rows(hist, new, pos)
        lib = library_merge(hist, new)
        torch.cuda.synchronize()
        err = max_bit_err(got, want)
        lib_err = max_bit_err(lib, want)
        case = {"case": name, "cap": cap, "b": b, "live": n_live,
                "max_abs_err": err, "library_max_abs_err": lib_err}
        out["cases"].append(case)
        if err or lib_err:
            emit(out)
            raise AssertionError(f"merge {name}: kernel err {err}, library "
                                 f"err {lib_err} against the plain version")
        if name == TIMED:
            timed = (hist, new, pos, case)
    hist, new, pos, case = timed
    cap, b = case["cap"], case["b"]
    case["ms"] = median_ms(lambda: dedup.merge_rows_cuda(hist, new, pos))
    case["call_ms"] = call_ms(lambda: dedup.merge_rows_cuda(hist, new, pos))
    case["plain_ms"] = median_ms(lambda: dedup.merge_rows(hist, new, pos))
    case["library_ms"] = median_ms(lambda: library_merge(hist, new))
    # the bytes a merge must move: each of the cap output rows (24 bytes:
    # h0, h1 int64, qor, age) written once and read once from its one
    # source row, new or history; every position read once.  Batch rows
    # that land at or past cap are never read.
    nbytes = 48 * cap + 4 * b
    case["bytes"] = nbytes
    case["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    emit(out)
    return out, case


# -- the engine ----------------------------------------------------------------
def tree_to(x, dev):
    """Copy a state / draws tree (NamedTuples, tuples, tensors, None) to
    `dev`; other leaves (a generator) pass through."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_to(v, dev) for v in x))
    if isinstance(x, tuple):
        return tuple(tree_to(v, dev) for v in x)
    return x


def tree_leaves(x, prefix="state"):
    """{path: tensor} over the tensors of a tree (the generator left out)."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    out = {}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            out.update(tree_leaves(v, f"{prefix}.{name}"))
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            out.update(tree_leaves(v, f"{prefix}[{i}]"))
    return out


def is_perm_rows(pm: torch.Tensor, n: int) -> bool:
    pm = pm.reshape(-1, n)
    want = torch.arange(n, device=pm.device).expand_as(pm)
    return bool(torch.equal(torch.sort(pm, dim=1).values, want))


def engine_phase(dev) -> tuple:
    from uptune_tpu_torch import native
    from uptune_tpu_torch.flagship import (N_CITIES, flagship,
                                           flagship_objective)
    eng = flagship(SCALE, history_capacity=CAPACITY, device=dev)
    rows = eng.total_batch
    if rows != 6040:
        raise AssertionError(f"scale {SCALE} gives {rows} rows a step, "
                             f"not 6040")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = eng.init(seed=SEED)
    st = eng.step(st)                       # warm step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    native.reset_launches()                 # the main path's run starts here
    t0 = time.perf_counter()
    for _ in range(STEPS):
        st = eng.step(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in native.KERNELS}

    best = eng.best_qor(st)
    de = st.tstates[0]
    out = {"phase": "engine", "scale": SCALE, "rows_per_step": rows,
           "history_capacity": CAPACITY, "steps": STEPS,
           "seconds": wall, "ms_per_step": wall / STEPS * 1e3,
           "acquisitions_per_s": rows * STEPS / wall,
           "init_and_warm_step_s": warm_s, "best_qor": best,
           "evals": int(st.evals), "acqs": int(st.acqs),
           "hist_n": int(st.hist.n), "hist_dropped": int(st.hist.dropped),
           "launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    if launches["merge_rows"] != STEPS:
        raise AssertionError(f"merge kernel launched {launches['merge_rows']}"
                             f" times in {STEPS} commits")
    if not torch.isfinite(torch.tensor(best)):
        raise AssertionError(f"best_qor {best} is not finite")
    for what, pm in (("DE population", de.pop.perms[0]),
                     ("best", st.best.perms[0])):
        if not is_perm_rows(pm, N_CITIES):
            raise AssertionError(f"{what}: a tour is not a permutation")
    h0 = st.hist.h0
    if not bool((h0[1:] >= h0[:-1]).all()):
        raise AssertionError("history h0 is not sorted")
    # the best's QoR, re-scored on the CPU by the same objective (the sum
    # order differs on the card: tolerance 1e-5 relative)
    cpu = torch.device("cpu")
    vals = eng.space.decode_scalars(st.best.u[None].to(cpu))
    ref_q = float(flagship_objective(cpu)(
        vals, (st.best.perms[0][None].to(cpu),))[0])
    if abs(ref_q - best) > 1e-5 * max(1.0, abs(best)):
        raise AssertionError(f"best_qor {best} but the CPU objective gives "
                             f"{ref_q}")
    torch.cuda.synchronize()
    return eng, st, out


def reference_phase(eng, st, dev) -> dict:
    """One commit on the card and on the CPU from the same inputs.  The
    proposal is snapped through the host codecs (`to_configs` then
    `from_configs`) so no LOG_INT lane sits on a .5 rounding boundary,
    where the card's expm1 and the CPU's may round to different integers
    and hash differently; the raw QoR is computed once, on the CPU.  Every
    op of the commit is then exact, so the states must agree bitwise."""
    from uptune_tpu_torch import rng
    from uptune_tpu_torch.flagship import flagship
    cpu = torch.device("cpu")
    eng_c = flagship(SCALE, history_capacity=CAPACITY, device=cpu)
    tst, cands = eng.propose(st)
    space = eng.space
    cands_c = space.from_configs(space.to_configs(cands), device=cpu)
    raw_c = eng_c.evaluate(cands_c)
    draws = eng.draw_observe(st.gen)
    st_c = tree_to(st, cpu)._replace(gen=rng.generator(SEED, cpu))
    out_g = eng.commit(st, tst, tree_to(cands_c, dev), raw_c.to(dev),
                       draws=draws)
    out_c = eng_c.commit(st_c, tree_to(tst, cpu), cands_c, raw_c,
                         draws=tree_to(draws, cpu))
    torch.cuda.synchronize()
    lg, lc = tree_leaves(out_g), tree_leaves(out_c)
    bad = [k for k in lc if not torch.equal(col_bits(lg[k].cpu()),
                                            col_bits(lc[k]))]
    res = {"phase": "reference", "tolerance": "bitwise",
           "leaves": len(lc), "mismatched": bad,
           "hist_dropped": int(out_c.hist.dropped)}
    emit(res)
    if bad or sorted(lg) != sorted(lc):
        raise AssertionError(f"card and CPU commits differ at {bad}")
    return res


def profile_phase(eng, st, ms_per_step: float, steps: int = 5) -> None:
    """Device time by kernel over a short window of engine steps, and the
    device's idle share of an unprofiled step (`ms_per_step`, timed in the
    engine phase): the profiler's own host cost would inflate the window's
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            st = eng.step(st)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:      # kernels, copies, sets
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    emit({"phase": "profile", "steps": steps,
          "device_ms_per_step": busy_ms,
          "device_ops_per_step": sum(r[2] for r in rows) / steps,
          "ms_per_step_unprofiled": ms_per_step,
          "device_idle_share": 1 - busy_ms / ms_per_step,
          "top": [{"name": k[:90], "device_us_per_step": us / steps,
                   "count_per_step": n / steps}
                  for us, k, n in rows[:20]]})


# -- main --------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few engine steps")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from uptune_tpu_torch import native
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = native.build()
    kernels = native.KERNELS
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(p.relative_to(ROOT)) for k, p in libs.items()},
          "ptxas": {k.name: [ln.strip() for ln in k.build_log.splitlines()
                             if "registers" in ln or "smem" in ln]
                    for k in kernels}})

    merge, timed = merge_phase(dev)
    eng, st, engine = engine_phase(dev)
    reference_phase(eng, st, dev)
    if args.profile:
        profile_phase(eng, st, engine["ms_per_step"])

    entries = []
    for k in kernels:
        if k.name != "merge_rows":
            raise AssertionError(f"no smoke phase for kernel {k.name}")
        entries.append({
            "name": k.name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": k.replaces,
            "launches": engine["launches"][k.name],
            "max_abs_err": max(c["max_abs_err"] for c in merge["cases"]),
            "matched": True, "shape": f"cap={timed['cap']} b={timed['b']}",
            "ms": timed["ms"], "kernel_ms": timed["ms"],
            "call_ms": timed["call_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": "bytes",
            "library_ms": timed["library_ms"]})
    emit({"kernels": entries})
    torch.cuda.synchronize()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
