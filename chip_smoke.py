#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`uptune_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py              # the full check (one card)
    python3 chip_smoke.py --profile    # also a torch.profiler window

It imports nothing of JAX or of the JAX package.  TF32 is switched off
for matrix products (the GP's distances and Cholesky are f32) and the
setting is printed.  Phases, each printing one JSON line:

1. device  - the card (nvidia-smi name and power limit), torch and CUDA;
2. build   - every kernel of the port, built with nvcc from csrc/ (one
             nvcc per source, started together), with ptxas's registers,
             spills and shared memory for every kernel function;
3. merge   - the merge kernel against its plain version on the card, at
             cap 2^15 / b 6040 (half-full and full history), at the
             driver's cap 2^16 / b 32 (the Tuner's default history and
             its dedup bucket on the flagship's space; half-full and
             full), cap 2048 / b 2048, and at the edges: b = 70,000 into cap 2^15 (most rows
             land past cap), b = 1, b = cap with every new row before
             every history row, and cap 5000 / b 777 (cap not a multiple
             of a block's rows); all four columns bitwise; kernel, plain
             and library times (CUDA events, median of 50 runs after
             warm-up), and beside the byte bound the time of an empty
             kernel of the same grid (`launch_floor_ms`), at cap 2^15 /
             b 6040 and at the driver's shape; with --profile
             also the kernel at 128, 256 and 512 rows a block; and the
             merge over an instance axis (N 256, cap 2^11, b 114 and N 4,
             cap 2^15, b 6040: one launch for all N, bitwise per
             instance), timed against its byte bound, an empty kernel of
             its grid and N single launches;
4. surrogate - the GP of the surrogate path: `fit_auto_bucketed` on 1024
             evaluated flagship configurations (43 Cholesky factorizations
             of 1024^2) and `precompute_kinv`; a padded-bucket state (700
             real rows in a 1024 bucket), a 300-row state (N off the
             tensor-core tiles), a 3700-row state (N not a multiple of
             128, scored at 512 rows), and, at small size, a dense
             (n_cat = 0) and an all-categorical (n_cont = 0) state;
5. gp_kernels - launchers A-D of csrc/gp_tile.cu against their plain
             versions on the card, at the flagship's 6040 proposal rows
             against each state (every flag instance launches), and at
             the near-training case (the 1024 training rows, each
             continuous lane moved by +-0.01, against the main state,
             where the sd is smallest); every kind, top-k k = 128, an
             exact-tie case (every query row twice: A's means and D's
             values bitwise equal in pairs) and a 20000-row top-k whose
             candidates span several lists; max error against the
             stated tolerance, in the GP's standardized units (the units
             of the reference's tolerances), each side's distance from
             float64 and, for A, the shares of its error
             (`mean_attribution`); then kernel, eager-call, plain and
             library times and the bound at the main state (the 3xTF32
             tensor-core bound and the f32 one), and the time of C
             with kind "mean" (its kernel rows and final passes alone);
6. engine  - the flagship at scale 64 (6040 rows a step, a 2^15-row
             history): init, one warm step, then the timed steps with the
             launch counts set to 0 just before and read just after; one
             merge launch per commit, a finite best, valid permutations;
7. reference - one commit of that engine's state on the card and on the
             CPU (plain versions) from the same inputs: the whole state
             bitwise equal (the observe draws come from the same key on
             both devices);
8. surrogate_engine - the surrogate-guided flagship: 50 steps scored by
             `surrogate_eval_fn(kind="ei", impl="fused")`, a publish of a
             refit, 50 `propose_topk(..., 128)`, then 10 steps each with
             impl="score_flat" for kind "mean" and "ei"; counts set to 0
             just before and read just after (C 50, D 50, A 10, B 10,
             merge 70); a finite best, valid tours, and the last epoch's
             scores on the card against the same scoring on the CPU;
9. batched - the JAX package's multi-instance protocol (bench.py
             --multi): rosenbrock-16d, default arms at scale 1 (114 rows
             an instance), a 2^11-row history, N = 256, 50 steps, then
             the same with exchange_every = 16; aggregate acquisitions/s,
             ms/step and launches (the merge once a step); every
             instance's best equal to the global minimum bitwise right
             after an exchanging step; the CUDA kernels a step launches
             (profiler) and the ops it dispatches, equal at N = 4 and
             N = 256; the speedup over N times one instance's step;
10. batched_flagship - the flagship at scale 64 over N = 4 instances
             (24,160 rows a step, a 2^15-row history each), 20 steps
             scored by launcher C on the flat batch (C 20, merge 20
             launches); C's scores of a flat batch against the CPU's
             within the sd tolerance; a 10-step batched run equal to four
             card FusedEngine runs from `instance_seeds` bitwise; one
             batched commit (with the exchange) on the card and on the
             CPU bitwise, snapped through the host codecs;
11. tf32   - TF32 switched on globally, the 1024-row GP refitted: the fit
             and its scores against the TF32-off fit within the mean and
             sd tolerances, and the caller's setting left as it was;
12. portfolio_flagship - the flagship's space under every non-meta arm
             that supports it and is not a default arm (PSO and the GA
             under the five crossovers, ga-base, GGA, composable DE,
             bandit mutation, pattern search, annealing, RegularTorczon,
             MultiTorczon, MultiNelderMead) at scale 11: 6104 rows a
             step, a 2^15-row history; 50 plain steps, then 20 scored by
             launcher C against the surrogate phase's GP; launches (merge
             70, C 20), a finite best, every stored tour a permutation,
             C's scores of one proposal (6104 rows) against the CPU's,
             and one commit on the card and on the CPU bitwise;
13. portfolio_batched - 256 instances of rosenbrock-16d (a 2^11-row
             history each) under the AUCBanditMetaTechniqueTPU members
             (DE, normal greedy mutation, CMA-ES, NelderMead) plus
             pattern search, annealing, RegularTorczon, bandit mutation
             and MultiNelderMead: 294 rows an instance, 75,264 a step;
             30 steps exchanging every 16 (the merge once a step, every
             best equal to the global minimum right after the exchange);
             the ops a step equal at N = 4 and N = 256 (dispatched
             ops, and device ops in each of several profiler windows
             on the same inputs, one for each launch call of the host;
             a window in which the profiler dropped device records is
             retaken); the host
             synchronisations a step (CMA-ES's batched `eigh`); instances
             0, 127 and 255 of an 8-step run bitwise equal to single card
             runs; one batched commit on the card and on the CPU: bitwise
             but for CMA-ES's state, whose eigendecomposition differs
             between cuSOLVER and LAPACK (held to rtol 1e-5 / atol 1e-6,
             the basis through B diag(lambda) B^T);
14. driver - the ask/tell tuning driver, `Tuner(flagship_space(),
             flagship_host_objective(card)).run(test_limit=5000)`: the
             library's default budget, history (2^16 rows) and portfolio
             (AUCBanditMetaTechniqueA, a 32-row dedup bucket), after an
             untimed warm-up tune; counts set to 0 just before `run` and
             read just after (one merge launch for every committing
             ticket, nothing else); tickets, evals/s, ms a ticket, the
             median `t_propose` / `t_dedup`, the host synchronisations
             and the device ops a ticket; no configuration evaluated
             twice (the archive's hashes unique), nothing evicted, a
             finite best, every stored tour a permutation; the same tune
             on the CPU in this process (ms a ticket, evals/s); a CPU
             Tuner resuming the card's archive, whose live history rows,
             best, evals and trace must equal the card's bitwise; a tune
             at cap 2^12 and 8000 evaluations that evicts inside its
             commits, one commit of it replayed on the CPU bitwise; and
             ask(min_trials=256) told in a seeded shuffled order with one
             ticket fully and one partly cancelled (no hash out twice,
             evals equal to the trials told, no observe and no credit for
             the withdrawn ticket);
15. surrogate_driver - the Tuner with the port's surrogate manager:
             `Tuner(flagship_space(), flagship_host_objective(card),
             surrogate="gp", surrogate_opts={**CALIBRATED_OPTS,
             "async_refit": True}).run(test_limit=2000)` under a caller's
             TF32 setting (counts set to 0 just before, read just after:
             one merge launch a committing ticket, no launch of D, whose
             gate the 512-row pool is below); tickets, evals/s, ms a
             ticket, median t_propose / t_dedup, host syncs a ticket by
             line, refits started and published, extensions, blocking
             and background refit seconds, rows pruned, surrogate
             tickets; no configuration evaluated twice, tours
             permutations, a finite best, snapshot versions that never go
             down, every published tensor finite after drain(), the TF32
             setting kept and one refit under it equal to one without;
             the same tune on the CPU; then the 4096-row pool (D once a
             pool pull, D's top-32 held against its plain version on the
             card at every published snapshot a pull ranked against,
             buckets and extension-grown states, and timed at each bucket
             N beside its bound and `acquire_topk_ref`); the MLP ensemble
             (1000 evaluations; one fit on the card against the CPU's);
             and one GP refit on the card against the CPU's;
16. profile (with --profile) - device time by kernel, the idle share and
             the host synchronisations over a few plain, surrogate-scored
             (by launcher C, then by `score_flat` through A and through B),
             batched (N = 256 and the N = 4 flagship) and portfolio
             (plain and scored flagship, batched N = 256) engine steps
             and driver tickets (plain, and with the calibrated GP
             manager), and the device time of A's kernel and of each
             pass of B, C and D;
17. kernels - one entry per kernel: launches on the main path, error
             against the plain version (and, for the GP kernels, its
             largest ratio to the tolerance), times and bound; the merge
             also over its instance axis and at the driver's shape, and
             the launches of the batched, portfolio, driver and surrogate
             driver paths (D also timed at the manager's shapes).

"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM, NVIDIA's data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s f32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12    # dense, on the tensor cores
REPS = 50
# the engine run: the flagship at the size of the JAX package's TPU
# headline (bench.py), 6040 rows a step into a 2^15-row history
SCALE, CAPACITY, STEPS, SEED = 64, 1 << 15, 200, 0
SIZES = (  # (name, cap, b, live history rows)
    ("cap32768_b6040_half", 1 << 15, 6040, 1 << 14),
    ("cap32768_b6040_full", 1 << 15, 6040, 1 << 15),
    ("cap65536_b32_half", 1 << 16, 32, 1 << 15),
    ("cap65536_b32_full", 1 << 16, 32, 1 << 16),
    ("cap2048_b2048", 2048, 2048, 2000),
)
TIMED, DRIVER_TIMED = "cap32768_b6040_full", "cap65536_b32_full"
# rows a block of the merge kernel may take (csrc/merge.cu instantiates
# these; the library reports the one the port uses)
MERGE_ROWS = (128, 256, 512)
# the surrogate path: the manager's max_points (its largest bucket), a
# padded bucket, the small dense / all-categorical states, and k = 128,
# the manager's smallest pool routed to the fused top-k (propose_batch 128
# x pool_mult 32 = 4096 = PALLAS_MIN_POOL)
N_TRAIN, N_PADDED, N_SMALL, TOP_K = 1024, 700, 256, 128
# a training set whose N is not a multiple of the tensor-core tiles, and
# how far the near-training queries sit from their training rows (each
# continuous lane moved by +-NEAR, seeded)
N_RAGGED, NEAR = 300, 0.01
# a training set of more rows than a [16, N] tile in one block's shared
# memory allows (3584 at 31 features), N not a multiple of the 128-wide
# tiles; and the rows scored against it
N_LARGE, LARGE_ROWS = 3700, 512
# query rows for a top-k whose candidates span several merge groups
MANY_ROWS = 20000
SURR_STEPS, TOPK_EPOCHS, FLAT_STEPS = 50, 50, 10
# the JAX package's multi-instance protocol (bench.py --multi): N
# instances of rosenbrock-16d in [-5, 5], a 2^11-row history each, 50
# steps; then with the best exchanged every 16 steps; launches a step are
# compared at N = 4 and N = 256
MULTI_N, MULTI_SMALL_N, MULTI_STEPS, MULTI_CAP = 256, 4, 50, 1 << 11
MULTI_EXCHANGE = 16
MULTI_SINGLE_STEPS = 20     # steps of one instance alone, the yardstick
# the batched flagship: N instances at scale 64 (the single engine's
# history each), steps scored by launcher C, and the matched-seed run
BF_N, BF_STEPS, BF_MATCH_STEPS = 4, 20, 10
# the merge over an instance axis: (N, cap, b) of the two batched paths
MERGE_INSTANCES = ((MULTI_N, MULTI_CAP, 114), (BF_N, CAPACITY, 6040))
# the portfolio paths: the flagship under the new arms at scale 11 (6104
# rows a step), plain then scored by launcher C; and the multi-instance
# protocol under nine arms (294 rows an instance), exchanging every 16
# steps, with a shorter run held against single runs of three instances
PF_SCALE, PF_ROWS, PF_STEPS, PF_SCORED = 11, 6104, 50, 20
PB_N, PB_ROWS, PB_STEPS, PB_MATCH_STEPS = 256, 294, 30, 8
PB_MATCH = (0, 127, 255)
# the driver: the library's default budget and history on the flagship's
# space (the default portfolio's dedup bucket there is 32 rows), after an
# untimed warm-up tune; a tune at a history that fills and evicts; the
# trials one ask() takes; the tickets whose syncs and ops are counted
DRIVER_LIMIT, DRIVER_CAP, DRIVER_B, DRIVER_WARM = 5000, 1 << 16, 32, 300
EVICT_LIMIT, EVICT_CAP = 8000, 1 << 12
ASK_TRIALS, COUNT_TICKETS = 256, 20
# the surrogate driver: the calibrated GP manager with async refits (as
# program mode runs it) at the JAX package's surrogate-protocol budget,
# then the smallest pool the reference ranks with its fused top-k
# (propose_batch 32 x pool_mult 128 = 4096 rows) with sync refits, and
# the MLP ensemble; the MLP's card-against-CPU tolerance in units of the
# targets' std (tests/test_torch_mlp.py FIT_TOL_Y_STD)
SD_LIMIT, SD_POOL_LIMIT, SD_MLP_LIMIT = 2000, 1000, 1000
SD_POOL = {"propose_batch": 32, "pool_mult": 128}
MLP_TOL_Y_STD = 1e-4
# 3xTF32 (hi hi + hi lo + lo hi) drops the lo lo product: a relative
# error of up to 2^-22 a product against float32's 2^-24, so where an
# ill-conditioned K^-1 magnifies rounding D may sit up to 4x as far from
# float64 as the float32 plain version
TF32_ERROR_RATIO = 4.0
# profiler windows the portfolio step's launch count takes at each N, the
# windows that may be retaken when the profiler drops device records
# (`launch_counts`), and the empty kernels that open every profiler
# window (`profiled`)
COUNT_WINDOWS, RETAKES = 3, 4
SENTINELS, SENTINEL_KERNEL = 8, "launch_floor_kernel"
# CMA-ES's state on the card against the CPU's (tests/test_torch_
# techniques.py holds the port to the JAX package at the same tolerance)
CMA_TOL = {"rtol": 1e-5, "atol": 1e-6}
# tolerances (tests/test_pallas_score.py:31,137-139): the posterior mean,
# and sd / EI / LCB
MEAN_TOL = {"rtol": 1e-4, "atol": 1e-5}
SD_TOL = {"rtol": 1e-3, "atol": 1e-5}
BETA = 2.0
# a utility is held to the tolerances of the moments it is made of: LCB
# = -(mean - beta sd) to the mean's plus beta times the sd's, EI (whose
# derivatives in mean and sd are at most 1 in size) to the mean's plus
# the sd's; -mean to the mean's
UTILITY_TOL = {"mean": "mean", "ei": "mean + sd", "lcb": "mean + beta sd"}
NEAR_CASE = "mixed_n1024_near_training"


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


def edge_merges(dev):
    """(name, hist, new, pos) at the edges of the merge: more new rows
    than one block's shared memory could hold positions of (58,112), most
    of them past cap; one row, in the middle; a batch of cap rows that all
    come before the history; a cap that no block size divides."""
    yield ("cap32768_b70000_mostly_past_cap",
           *merge_inputs(1 << 15, 70000, 1 << 15, 110, dev))
    hist, new, pos = merge_inputs(1 << 15, 16, 1 << 14, 111, dev)
    yield ("cap32768_b1", hist, tuple(c[7:8].contiguous() for c in new),
           (pos[7:8] - 7).contiguous())
    cap = 4096
    hist, new, _ = merge_inputs(cap, cap, cap, 112, dev)
    hist = (hist[0] + (1 << 20),) + hist[1:]
    new = (torch.sort(new[0] % (1 << 20)).values,) + new[1:]
    yield ("cap4096_b4096_new_before_history", hist, new,
           torch.arange(cap, device=dev, dtype=torch.int32))
    yield ("cap5000_b777", *merge_inputs(5000, 777, 4000, 113, dev))


def merge_library(symbol: str, argtypes):
    """A C function of the merge kernel's library that the port itself
    does not call (the kernel at another block size, the empty kernel)."""
    from uptune_tpu_torch import native
    fn = getattr(native.MERGE.library(), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def merge_phase(dev, sweep: bool) -> dict:
    from uptune_tpu_torch import native
    from uptune_tpu_torch.ops import dedup
    out = {"phase": "merge", "tolerance": "bitwise", "cases": []}
    timed = {}
    cases = [(name, *merge_inputs(cap, b, n_live, 100 + i, dev))
             for i, (name, cap, b, n_live) in enumerate(SIZES)]
    cases += list(edge_merges(dev))
    with_rows = merge_library("ut_merge_rows_with", [ctypes.c_void_p] * 13
                              + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def merge_at(rows, hist, new, pos):
        """The kernel at `rows` rows a block: not the port's wrapper, so
        no launch is counted."""
        res = tuple(torch.empty_like(h) for h in hist)
        native.check(with_rows(
            *(t.data_ptr() for t in hist), *(t.data_ptr() for t in new),
            pos.data_ptr(), *(t.data_ptr() for t in res), 1,
            hist[0].shape[0], new[0].shape[0], rows,
            torch.cuda.current_stream().cuda_stream),
            native.MERGE)
        return res

    for name, hist, new, pos in cases:
        cap, b = hist[0].shape[0], new[0].shape[0]
        got = dedup.merge_rows_cuda(hist, new, pos)
        want = dedup.merge_rows(hist, new, pos)
        lib = library_merge(hist, new)
        torch.cuda.synchronize()
        err = max_bit_err(got, want)
        lib_err = max_bit_err(lib, want)
        case = {"case": name, "cap": cap, "b": b,
                "new_rows_kept": int((pos < cap).sum()),
                "max_abs_err": err, "library_max_abs_err": lib_err}
        if sweep:
            case["max_abs_err_by_rows_per_block"] = {
                r: max_bit_err(merge_at(r, hist, new, pos), want)
                for r in MERGE_ROWS}
            err = max(err, *case["max_abs_err_by_rows_per_block"].values())
        out["cases"].append(case)
        if err or lib_err:
            emit(out)
            raise AssertionError(f"merge {name}: kernel err {err}, library "
                                 f"err {lib_err} against the plain version")
        if name in (TIMED, DRIVER_TIMED):
            timed[name] = (hist, new, pos, case)
    floor = merge_library("ut_merge_launch_floor",
                          [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def floor_ms(rows, n, cap):   # an empty kernel of the grid
        return median_ms(lambda: native.check(floor(
            n, cap, rows, torch.cuda.current_stream().cuda_stream),
            native.MERGE))
    for hist, new, pos, case in timed.values():
        cap, b = case["cap"], case["b"]
        case["rows_per_block"] = native.MERGE.query(
            "ut_merge_rows_per_block")
        case["ms"] = median_ms(lambda: dedup.merge_rows_cuda(hist, new, pos))
        case["launch_floor_ms"] = floor_ms(0, 1, cap)
        case["call_ms"] = call_ms(
            lambda: dedup.merge_rows_cuda(hist, new, pos))
        case["plain_ms"] = median_ms(lambda: dedup.merge_rows(hist, new, pos))
        case["library_ms"] = median_ms(lambda: library_merge(hist, new))
        # the bytes a merge must move: each of the cap output rows (24
        # bytes: h0, h1 int64, qor, age) written once and read once from
        # its one source row, new or history; every position read once.
        # Batch rows that land at or past cap are never read.
        case["bytes"] = 48 * cap + 4 * b
        case["bound_ms"] = case["bytes"] / HBM_BYTES_PER_S * 1e3
    hist, new, pos, case = timed[TIMED]
    cap = case["cap"]
    if sweep:
        # the block sizes in turns, three rounds: one round's order and
        # the card's state weigh as much as the sizes differ
        rounds = [{r: (median_ms(lambda: merge_at(r, hist, new, pos)),
                       floor_ms(r, 1, cap)) for r in MERGE_ROWS}
                  for _ in range(3)]
        case["sweep"] = {
            r: {"ms": statistics.median(x[r][0] for x in rounds),
                "ms_rounds": [x[r][0] for x in rounds],
                "launch_floor_ms": statistics.median(x[r][1] for x in rounds)}
            for r in MERGE_ROWS}
        # the port's own call once more, after the rounds: how far one
        # kernel's time moves within this phase
        case["ms_after_sweep"] = median_ms(
            lambda: dedup.merge_rows_cuda(hist, new, pos))
    out["instance_axis"] = [merge_instances_case(n, c, bb, floor_ms, dev)
                            for n, c, bb in MERGE_INSTANCES]
    emit(out)
    bad = [c for c in out["instance_axis"] if c["max_abs_err"]]
    if bad:
        raise AssertionError(f"merge over an instance axis differs from "
                             f"the plain version: {bad}")
    return out, case, timed[DRIVER_TIMED][3]


def merge_instances_case(n: int, cap: int, b: int, floor_ms, dev) -> dict:
    """The merge of n instances in one launch ([n, cap] histories filled
    to a quarter, a half, three quarters and all of cap in turn) against
    the plain version, bitwise per instance; its time against the bytes
    of n merges, an empty kernel of its grid, and n single launches (one
    an instance, as a per-instance loop would make them)."""
    from uptune_tpu_torch.ops import dedup
    parts = [merge_inputs(cap, b, cap * (i % 4 + 1) // 4, 200 + i, dev)
             for i in range(n)]
    hist = tuple(torch.stack([p[0][j] for p in parts]) for j in range(4))
    new = tuple(torch.stack([p[1][j] for p in parts]) for j in range(4))
    pos = torch.stack([p[2] for p in parts])
    got = dedup.merge_rows_cuda(hist, new, pos)
    want = dedup.merge_rows(hist, new, pos)
    torch.cuda.synchronize()
    rows = [tuple(c[i] for c in hist) for i in range(n)]
    news = [tuple(c[i] for c in new) for i in range(n)]

    def singles():
        for i in range(n):
            dedup.merge_rows_cuda(rows[i], news[i], pos[i])
    nbytes = n * (48 * cap + 4 * b)
    return {"shape": f"N={n} cap={cap} b={b}", "instances": n, "cap": cap,
            "b": b, "max_abs_err": max_bit_err(got, want),
            "ms": median_ms(lambda: dedup.merge_rows_cuda(hist, new, pos)),
            "call_ms": call_ms(lambda: dedup.merge_rows_cuda(hist, new,
                                                             pos)),
            "launch_floor_ms": floor_ms(0, n, cap),
            "single_launches_ms": median_ms(singles, reps=10, per_rep=2),
            "single_calls_ms": call_ms(singles, reps=5, per_rep=1),
            "plain_ms": median_ms(lambda: dedup.merge_rows(hist, new, pos)),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


# -- the surrogate path ---------------------------------------------------------
def surrogate_phase(dev) -> tuple:
    """The GP states the gp_kernels and surrogate_engine phases score
    against: {case: (GPState, queries [rows, F], best_y, n_cont, n_cat)}."""
    from uptune_tpu_torch.flagship import flagship_surrogate
    from uptune_tpu_torch.surrogate import gp
    x, y, (nc, ncat) = flagship_surrogate(N_TRAIN, SEED + 1, dev)
    xq, _, _ = flagship_surrogate(6040, SEED + 2, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main = gp.precompute_kinv(gp.fit_auto_bucketed(
        x, y, max_points=N_TRAIN, n_cont=nc, n_cat=ncat))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    padded = gp.precompute_kinv(gp.fit_auto_bucketed(
        x[:N_PADDED], y[:N_PADDED], max_points=N_TRAIN, n_cont=nc,
        n_cat=ncat))
    xs, ys = x[:N_SMALL], y[:N_SMALL]
    dense = gp.precompute_kinv(gp.fit_auto_bucketed(
        xs[:, :nc].contiguous(), ys, max_points=N_TRAIN))
    allcat = gp.precompute_kinv(gp.fit_auto_bucketed(
        xs[:, nc:].contiguous(), ys, max_points=N_TRAIN, n_cont=0,
        n_cat=ncat))
    ragged = gp.precompute_kinv(gp.fit(
        x[:N_RAGGED], y[:N_RAGGED], main.lengthscale, main.noise,
        n_cont=nc, n_cat=ncat, ls_cat=main.ls_cat))
    xl, yl, _ = flagship_surrogate(N_LARGE, SEED + 6, dev)
    large = gp.precompute_kinv(gp.fit(
        xl, yl, main.lengthscale, main.noise, n_cont=nc, n_cat=ncat,
        ls_cat=main.ls_cat))
    # the training rows themselves, each continuous lane moved by +-NEAR:
    # the posterior sd is small there and k K^-1 cancels the most
    gen = torch.Generator().manual_seed(SEED + 5)
    sign = torch.randint(0, 2, (N_TRAIN, nc), generator=gen) * 2.0 - 1.0
    near = x.clone()
    near[:, :nc] += NEAR * sign.to(dev)
    cases = {
        "mixed_n1024": (main, xq, float(y.min()), nc, ncat),
        "mixed_n700_in_1024": (padded, xq, float(y[:N_PADDED].min()), nc,
                               ncat),
        "dense_n256": (dense, xq[:, :nc].contiguous(), float(ys.min()),
                       None, 0),
        "allcat_n256": (allcat, xq[:, nc:].contiguous(), float(ys.min()),
                        0, ncat),
        "mixed_n300_ragged": (ragged, xq, float(y[:N_RAGGED].min()), nc,
                              ncat),
        NEAR_CASE: (main, near.contiguous(), float(y.min()), nc, ncat),
        f"mixed_n{N_LARGE}": (large, xq[:LARGE_ROWS].contiguous(),
                              float(yl.min()), nc, ncat),
    }
    out = {"phase": "surrogate", "features": int(x.shape[1]),
           "n_cont": nc, "n_cat": ncat, "fit_auto_bucketed_s": fit_s,
           "states": {}}
    for name, (st, q, best, _, _) in cases.items():
        out["states"][name] = {
            "bucket": int(st.x.shape[0]), "real_rows": int(st.mask.sum()),
            "features": int(st.x.shape[1]),
            "lengthscale": float(st.lengthscale), "noise": float(st.noise),
            "ls_cat": float(st.ls_cat), "y_mean": float(st.y_mean),
            "y_std": float(st.y_std), "best_y": best}
        for f in ("alpha", "chol", "kinv"):
            if not bool(torch.isfinite(getattr(st, f)).all()):
                emit(out)
                raise AssertionError(f"state {name}: {f} is not finite")
    emit(out)
    return cases, (nc, ncat)


def tol_excess(got, want, tol, scale=1.0, offset=0.0) -> tuple:
    """(max |got - want|, max |got - want| / (atol + rtol |want|)) with
    both sides taken as (v - offset) / scale: the check passes where the
    second is at most 1."""
    g = (got.double() - offset) / scale
    w = (want.double() - offset) / scale
    d = (g - w).abs()
    lim = tol["atol"] + tol["rtol"] * w.abs()
    return float((got.double() - want.double()).abs().max()), float(
        (d / lim).max())


def topk_index_mismatches(iw, vw, ig, tol) -> int:
    """Ranks whose value stands apart from its neighbours by more than
    twice the tolerance, where the two selections' indices differ."""
    v = vw.double()
    band = tol["atol"] + tol["rtol"] * v.abs()
    gap = torch.full_like(v, float("inf"))
    if v.numel() > 1:
        dv = v[:-1] - v[1:]
        gap[1:] = torch.minimum(gap[1:], dv)
        gap[:-1] = torch.minimum(gap[:-1], dv)
    apart = gap > 2 * band
    return int((ig[apart] != iw[apart]).sum())


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 t rounded to TF32 (10 fraction bits), ties away from zero: the
    kernels' `tf32_rna`."""
    return ((t.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split_d2_f64(q, x):
    """|q - x|^2 [B, N] from A's operands of one block (f32, or None): as
    launcher A rounds them, centred on x[0] in f32 and split into TF32 hi
    + lo; then |q|^2 + |x|^2 - 2 (lo hi + hi lo + hi hi), clamped at 0,
    in float64.  What the cross term's 3xTF32 split alone costs."""
    if q is None:
        return None
    q, x = q - x[0], x - x[0]
    qh, xh = tf32_rna(q), tf32_rna(x)
    ql, xl = tf32_rna(q - qh), tf32_rna(x - xh)
    q, x, qh, xh, ql, xl = (t.double() for t in (q, x, qh, xh, ql, xl))
    dot = ql @ xh.T + qh @ xl.T + qh @ xh.T
    return torch.clamp_min((q * q).sum(1)[:, None] + (x * x).sum(1)[None]
                           - 2.0 * dot, 0.0)


def mean_attribution(blocks, k64, mu64, lim) -> dict:
    """Where A's error against float64 can come from, each over the mean
    limit (standardized units): `split_f64` the cross term's 3xTF32 split
    (all else float64), `k32` every k rounded to f32 once (summed in
    float64), `sum32` the float64 terms k alpha summed in f32 (torch's
    order), and `sum_u` f32's unit roundoff times sum |k alpha|, the
    scale of any f32 sum's rounding."""
    from uptune_tpu_torch.surrogate import pallas_score as ps
    qc, qk, xc, xk, alpha = blocks
    a64 = alpha.double()
    dc, dk = split_d2_f64(qc, xc), split_d2_f64(qk, xk)
    ks = torch.exp(-dk) if dc is None else ps.matern_tile(dc)
    if dc is not None and dk is not None:
        ks = ks * torch.exp(-dk)
    terms = k64 * a64

    def over(v):
        return float(((v - mu64).abs() / lim).max())
    return {"split_f64_err_over_tol": over(ks @ a64),
            "k32_err_over_tol": over(k64.float().double() @ a64),
            "sum32_err_over_tol": over(terms.float().sum(1).double()),
            "sum_u_over_tol": float((terms.abs().sum(1) * 2.0 ** -24
                                     / lim).max())}


def gp_bound(b: int, n: int, f: int, var: bool, out_bytes: int) -> dict:
    """The least time for one call: its FLOPs (distances 2BNF, mean 2BN,
    and for the variance kinds k K^-1 2BN^2 plus q 2BN) or its bytes
    (queries, training rows, alpha, K^-1, outputs, each once) over HBM's
    rate, whichever is larger.  Every launcher runs one product on the
    tensor cores in 3xTF32, which keeps f32's accuracy: k K^-1 (B, C and
    D) or the distances' cross term (A).  It counts as 3x its FLOPs in
    TF32 at the dense TF32 rate, the rest at the f32 rate; `bound_f32_ms`
    is the bound with every FLOP at the f32 rate, beside it."""
    mm = 2 * b * n * n if var else 0
    rest = 2 * b * n * f + 2 * b * n + (2 * b * n if var else 0)
    tc = mm if var else 2 * b * n * f
    nbytes = 4 * (b * f + n * f + n + (n * n if var else 0)) + out_bytes
    t_f32 = (mm + rest) / FP32_FLOP_PER_S
    t_ops = 3 * tc / TF32_FLOP_PER_S + (mm + rest - tc) / FP32_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": mm + rest, "tf32_flops": 3 * tc, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_f32_ms": max(t_f32, t_bytes) * 1e3}


def gp_kernels_phase(cases) -> tuple:
    """Launchers A-D against their plain versions on the card, on every
    state, compared in target units (mean, sd, utility) at the stated
    tolerances; then times and bounds at the main state."""
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import pallas_score as ps
    out = {"phase": "gp_kernels",
           "tolerances": {"mean": MEAN_TOL, "sd": SD_TOL, "beta": BETA,
                          "utilities": UTILITY_TOL},
           "tolerance_units": "the GP's standardized units: (mean - "
                              "y_mean) / y_std, sd / y_std; each limit "
                              "atol + rtol |plain value| per row",
           "f64": "kernel_f64_err_over_tol / plain_f64_err_over_tol: the "
                  "kernel's and the plain version's distance from the same "
                  "function in float64, over the same limits; for "
                  "gp_mean also the shares of its sources of error "
                  "(mean_attribution)",
           "cases": []}
    err = {"gp_mean": 0.0, "gp_mean_var": 0.0, "acquire_scores": 0.0,
           "acquire_topk": 0.0}
    over = dict(err)
    bad = []

    def record(case, kernel, what, got, want, lim, scale, ref):
        # |got - want| / y_std against the per-row limit in the GP's
        # standardized units, the units of the reference's tolerances (its
        # fixtures have y_std ~ 1); max_abs_err stays in target units
        d = (got.double() - want.double()).abs()
        e, x = float(d.max()), float((d / scale / lim).max())
        err[kernel] = max(err[kernel], e)
        over[kernel] = max(over[kernel], x)
        out["cases"].append({
            "case": case, "kernel": kernel, "what": what, "max_abs_err": e,
            "err_over_tol": x,
            "kernel_f64_err_over_tol": float(
                ((got.double() - ref).abs() / scale / lim).max()),
            "plain_f64_err_over_tol": float(
                ((want.double() - ref).abs() / scale / lim).max())})
        if not x <= 1.0:
            bad.append(f"{case} {kernel} {what}: {e} ({x:.3g}x the "
                       f"tolerance)")

    def limit(tol, v):               # atol + rtol |v|, v standardized
        return tol["atol"] + tol["rtol"] * v.double().abs()

    for case, (st, xq, best, nc, ncat) in cases.items():
        blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
        ys, ym = float(st.y_std), float(st.y_mean)

        def moments(mu_n, q=None):      # (mean, sd) in target units
            return ps.target_moments(mu_n, q, st.noise, st.y_mean, st.y_std)
        # the same function in float64, from the same float32 operands
        b64 = [None if t is None else t.double() for t in blocks]
        k64 = ps.kernel_tile(*b64[:4])
        mu64, q64 = ps.tile_moments(k64, b64[4], kinv.double())
        m64, s64 = moments(mu64, q64)
        (mw, sw) = moments(*ps.mean_var_tile_plain(*blocks, kinv))
        lim = {"mean": limit(MEAN_TOL, (mw - ym) / ys),
               "sd": limit(SD_TOL, sw / ys)}
        lim["ei"] = lim["mean"] + lim["sd"]
        lim["lcb"] = lim["mean"] + BETA * lim["sd"]
        record(case, "gp_mean", "mean", moments(ps.mean_tile_cuda(*blocks))[0],
               moments(ps.mean_tile_plain(*blocks))[0], lim["mean"], ys, m64)
        out["cases"][-1].update(
            mean_attribution(blocks, k64, mu64, lim["mean"]))
        mg, sg = moments(*ps.mean_var_tile_cuda(*blocks, kinv))
        record(case, "gp_mean_var", "mean", mg, mw, lim["mean"], ys, m64)
        record(case, "gp_mean_var", "sd", sg, sw, lim["sd"], ys, s64)
        for kind in ("mean", "ei", "lcb"):
            kv = None if kind == "mean" else kinv
            ref = acq.utilities(mu64, None if kind == "mean" else q64,
                                params.double(), kind)
            record(case, "acquire_scores", kind,
                   acq.scores_cuda(*blocks, kv, params, kind),
                   acq.utilities_plain(*blocks, kv, params, kind),
                   lim[kind], ys, ref)
        vg, ig = acq.topk_cuda(*blocks, kinv, params, "ei", TOP_K)
        vw, iw = acq.topk_plain(*blocks, kinv, params, "ei", TOP_K)
        ref = acq.utilities(mu64, q64, params.double(), "ei")[iw.long()]
        record(case, "acquire_topk", f"ei k={TOP_K} values", vg, vw,
               lim["ei"][iw.long()], ys, ref)
        miss = topk_index_mismatches(iw, vw / float(st.y_std), ig, SD_TOL)
        out["cases"][-1]["index_mismatches"] = miss
        if miss or not bool((vg[1:] <= vg[:-1]).all()):
            bad.append(f"{case} acquire_topk: {miss} separated ranks with "
                       f"other indices, or values not descending")

    # the near-training case: the smallest sd there, B's sd error and the
    # largest error of C's and D's sd-carrying utilities (EI, LCB), each
    # over its tolerance
    st, xq, _, nc, ncat = cases[NEAR_CASE]
    blocks, kinv, _ = acq.prep(st, xq, "ei", 0.0, BETA, nc, ncat)
    sd = ps.target_moments(*ps.mean_var_tile_plain(*blocks, kinv), st.noise,
                           st.y_mean, st.y_std)[1]
    out["near_training"] = {
        "rows": int(xq.shape[0]), "shift": NEAR,
        "min_sd_over_y_std": float(sd.min() / st.y_std),
        "sd_err_over_tol": max(c["err_over_tol"] for c in out["cases"]
                               if c["case"] == NEAR_CASE
                               and c["what"] == "sd"),
        "ei_lcb_err_over_tol": max(c["err_over_tol"] for c in out["cases"]
                                   if c["case"] == NEAR_CASE
                                   and c["kernel"].startswith("acquire")
                                   and c["what"] != "mean")}

    # exact ties: every query row twice, at i and i + half
    st, xq, best, nc, ncat = cases["mixed_n1024"]
    half = xq.shape[0] // 2
    blocks, kinv, params = acq.prep(
        st, torch.cat([xq[:half], xq[:half]]), "ei", best, BETA, nc, ncat)
    vg, ig = acq.topk_cuda(*blocks, kinv, params, "ei", TOP_K)
    vw, iw = acq.topk_plain(*blocks, kinv, params, "ei", TOP_K)
    mu = ps.mean_tile_cuda(*blocks)
    tie = {"case": "mixed_n1024_duplicated_rows", "kernel": "acquire_topk",
           "what": "exact ties lowest index first",
           "gp_mean_rows_tied": bool(torch.equal(mu[:half], mu[half:])),
           "pairs_tied": bool(torch.equal(vg[0::2], vg[1::2])),
           "lowest_first": bool(torch.equal(ig[0::2] + half, ig[1::2])
                                and bool((ig[0::2] < half).all())),
           "index_mismatches": topk_index_mismatches(
               iw, vw / float(st.y_std), ig, SD_TOL)}
    out["cases"].append(tie)
    if not (tie["pairs_tied"] and tie["lowest_first"]
            and tie["gp_mean_rows_tied"]) or tie["index_mismatches"]:
        bad.append(f"exact-tie top-k: {tie}")

    # more rows than one merge group holds (D then writes several lists
    # and the wrapper merges them): the query rows four times over, cut
    # to MANY_ROWS, so exact ties also span groups
    b0 = xq.shape[0]
    blocks, kinv, params = acq.prep(st, torch.cat([xq] * 4)[:MANY_ROWS],
                                    "ei", best, BETA, nc, ncat)
    vg, ig = acq.topk_cuda(*blocks, kinv, params, "ei", TOP_K)
    vw, iw = acq.topk_plain(*blocks, kinv, params, "ei", TOP_K)
    runs = torch.split(ig.long(), torch.unique_consecutive(
        vg, return_counts=True)[1].tolist())
    many = {"case": f"mixed_n1024_{MANY_ROWS}_rows", "kernel": "acquire_topk",
            "what": "several candidate lists",
            "candidate_slots": acq.TOPK_KERNEL.query(
                "ut_acquire_topk_slots", MANY_ROWS, TOP_K),
            "ties_lowest_first": all(
                bool((r[1:] > r[:-1]).all()) and bool((r % b0 == r[0] % b0).all())
                for r in runs),
            "values_max_err_over_tol": float(
                ((vg.double() - vw.double()).abs() / float(st.y_std)
                 / (SD_TOL["atol"] + SD_TOL["rtol"]
                    * (vw.double() / float(st.y_std)).abs())).max())}
    out["cases"].append(many)
    if not (many["ties_lowest_first"] and many["values_max_err_over_tol"] <= 1
            and many["candidate_slots"] > TOP_K
            and bool((vg[1:] <= vg[:-1]).all())):
        bad.append(f"top-k over several lists: {many}")
    torch.cuda.synchronize()
    if bad:
        emit(out)
        raise AssertionError("gp kernels disagree with their plain "
                             "versions: " + "; ".join(bad))

    # times at the main state: B = 6040, N = 1024, F = 31, EI, k = 128
    st, xq, best, nc, ncat = cases["mixed_n1024"]
    blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
    b, f = xq.shape
    n = st.x.shape[0]
    shape = f"B={b} N={n} F={f} (Fc={nc} Fk={f - nc})"
    # the launch geometry the library reports: the largest N at F
    # features must cover the manager's largest bucket (N_TRAIN)
    for kern in (ps.MEAN_VAR_KERNEL, acq.SCORES_KERNEL):
        out[f"{kern.name}_max_train_rows"] = lim = kern.query(kern.limit, f, 1)
        if lim < N_TRAIN:
            emit(out)
            raise AssertionError(f"{kern.name} takes at most {lim} training "
                                 f"rows at F={f}, fewer than {N_TRAIN}")
    out["acquire_topk_slots"] = acq.TOPK_KERNEL.query(
        "ut_acquire_topk_slots", b, TOP_K)
    out["acquire_scratch_bytes"] = 4 * ps.scratch_words(
        acq.TOPK_KERNEL, b, n, True, TOP_K)
    out["gp_mean_var_scratch_bytes"] = 4 * ps.scratch_words(
        ps.MEAN_VAR_KERNEL, b, n, True)

    def lib_mean():                  # the materialized [B, N] cross-kernel
        return ps.tile_moments(ps.kernel_tile(*blocks[:4]), blocks.alpha)[0]

    def lib_mean_var():
        return ps.tile_moments(ps.kernel_tile(*blocks[:4]), blocks.alpha,
                               kinv)

    timed = {
        "gp_mean": (lambda: ps.mean_tile_cuda(*blocks),
                    lambda: ps.mean_tile_plain(*blocks), lib_mean,
                    gp_bound(b, n, f, False, 4 * b), shape),
        "gp_mean_var": (lambda: ps.mean_var_tile_cuda(*blocks, kinv),
                        lambda: ps.mean_var_tile_plain(*blocks, kinv),
                        lib_mean_var, gp_bound(b, n, f, True, 8 * b),
                        shape),
        "acquire_scores": (
            lambda: acq.scores_cuda(*blocks, kinv, params, "ei"),
            lambda: acq.utilities_plain(*blocks, kinv, params, "ei"),
            lambda: acq.utilities_ref(*blocks, kinv, params, "ei"),
            gp_bound(b, n, f, True, 4 * b + 20), shape + " kind=ei"),
        "acquire_topk": (
            lambda: acq.topk_cuda(*blocks, kinv, params, "ei", TOP_K),
            lambda: acq.topk_plain(*blocks, kinv, params, "ei", TOP_K),
            lambda: acq.select_topk(
                acq.utilities_ref(*blocks, kinv, params, "ei"), TOP_K),
            gp_bound(b, n, f, True, 8 * TOP_K + 20),
            shape + f" kind=ei k={TOP_K}"),
    }
    times = {}
    for name, (kern, plain, lib, bound, shp) in timed.items():
        times[name] = dict(bound, shape=shp, max_abs_err=err[name],
                           max_err_over_tol=over[name],
                           ms=median_ms(kern), call_ms=call_ms(kern),
                           plain_ms=median_ms(plain),
                           library_ms=median_ms(lib))
    out["timed"] = times
    # C with kind "mean": the kernel rows without the k store, then the
    # final pass; the same mean as A by another route
    out["acquire_scores_kind_mean_ms"] = median_ms(
        lambda: acq.scores_cuda(*blocks, None, params, "mean"))
    emit(out)
    return out, times


# -- the engine ----------------------------------------------------------------
def tree_to(x, dev):
    """Copy a state / draws tree (NamedTuples, tuples, tensors, None) to
    `dev`; other leaves pass through."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_to(v, dev) for v in x))
    if isinstance(x, tuple):
        return tuple(tree_to(v, dev) for v in x)
    return x


def tree_leaves(x, prefix="state"):
    """{path: tensor} over the tensors of a tree (the key included)."""
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


def commit_on_cpu(eng, eng_c, st, dev) -> tuple:
    """One commit of `st` on the card (engine `eng`) and on the CPU
    (`eng_c`, the same arms) from the same inputs: (card state, CPU
    state).  The proposal is snapped through the host codecs
    (`to_configs` then `from_configs`) so no LOG_INT lane sits on a .5
    rounding boundary, where the card's expm1 and the CPU's may round to
    different integers and hash differently; the raw QoR is computed
    once, on the CPU.  The observe draws come from the same key on each
    device (the counter-based generator draws the same uniforms on
    both)."""
    cpu = torch.device("cpu")
    tst, cands, key = eng.propose(st)
    space = eng.space
    cands_c = space.from_configs(space.to_configs(cands), device=cpu)
    raw_c = eng_c.evaluate(cands_c)
    out_g = eng.commit(st, tst, tree_to(cands_c, dev), raw_c.to(dev), key)
    out_c = eng_c.commit(tree_to(st, cpu), tree_to(tst, cpu), cands_c,
                         raw_c, key.cpu())
    torch.cuda.synchronize()
    return out_g, out_c


def reference_phase(eng, st, dev) -> dict:
    """One commit on the card and on the CPU from the same inputs
    (`commit_on_cpu`).  Every op of the commit is then exact, so the
    states must agree bitwise."""
    from uptune_tpu_torch.flagship import flagship
    eng_c = flagship(SCALE, history_capacity=CAPACITY,
                     device=torch.device("cpu"))
    out_g, out_c = commit_on_cpu(eng, eng_c, st, dev)
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


def surrogate_engine_phase(eng, cases, feats: tuple, dev) -> dict:
    """The surrogate-guided flagship (see the module docstring), with the
    launch counts set to 0 just before and read just after."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import surrogate_aux, surrogate_eval_fn
    from uptune_tpu_torch.flagship import N_CITIES, flagship_surrogate
    from uptune_tpu_torch.surrogate import gp
    nc, ncat = feats
    st_gp, _, best, _, _ = cases["mixed_n1024"]
    space = eng.space
    opts = dict(n_cont=nc, n_cat=ncat)
    ev = surrogate_eval_fn(space, st_gp, kind="ei", best_y=best,
                           impl="fused", **opts)
    ev_mean = surrogate_eval_fn(space, st_gp, kind="mean",
                                impl="score_flat", **opts)
    ev_ei = surrogate_eval_fn(space, st_gp, kind="ei", best_y=best,
                              impl="score_flat", **opts)
    # the refit to publish: the chosen hyperparameters on a fresh draw of
    # 1024 evaluated configurations (same bucket, K^-1 attached)
    x2, y2, _ = flagship_surrogate(N_TRAIN, SEED + 3, dev)
    refit = surrogate_aux(gp.fit(x2, y2, st_gp.lengthscale, st_gp.noise,
                                 ls_cat=st_gp.ls_cat, **opts),
                          float(y2.min()), "ei")
    st = eng.step(eng.init(seed=SEED + 4), eval_fn=ev)     # warm step
    eng.propose_topk(st, ev, TOP_K)
    torch.cuda.synchronize()

    native.reset_launches()                # the main path's run starts here
    t0 = time.perf_counter()
    for _ in range(SURR_STEPS):
        st = eng.step(st, eval_fn=ev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev.publish(refit)
    tops = []
    for _ in range(TOPK_EPOCHS):
        _, cands, _, vals, idx = eng.propose_topk(st, ev, TOP_K)
        tops.append((vals, idx))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for e in (ev_mean, ev_ei):
        for _ in range(FLAT_STEPS):
            st = eng.step(st, eval_fn=e)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {k.name: k.launches for k in native.KERNELS}

    best_q = eng.best_qor(st)
    out = {"phase": "surrogate_engine", "scale": SCALE,
           "rows_per_step": eng.total_batch, "train_rows": N_TRAIN,
           "kind": "ei", "k": TOP_K,
           "fused_steps": SURR_STEPS,
           "fused_ms_per_step": (t1 - t0) / SURR_STEPS * 1e3,
           "propose_topk_epochs": TOPK_EPOCHS,
           "propose_topk_ms": (t2 - t1) / TOPK_EPOCHS * 1e3,
           "score_flat_steps": 2 * FLAT_STEPS,
           "score_flat_ms_per_step": (t3 - t2) / (2 * FLAT_STEPS) * 1e3,
           "best_qor": best_q, "launches": launches}
    want = {"acquire_scores": SURR_STEPS, "acquire_topk": TOPK_EPOCHS,
            "gp_mean": FLAT_STEPS, "gp_mean_var": FLAT_STEPS,
            "merge_rows": SURR_STEPS + 2 * FLAT_STEPS}
    # the last epoch's scores on the card against the same scoring on the
    # CPU (plain versions), from the same GP state and candidates
    cpu = torch.device("cpu")
    got = ev.fn(cands, ev.aux)
    ref = ev.fn(tree_to(cands, cpu), tree_to(ev.aux, cpu))
    out["cpu_reference_max_abs_err"], ratio = tol_excess(
        got.cpu(), ref, SD_TOL, float(ev.aux[0].y_std))
    emit(out)
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if not ratio <= 1.0:
        raise AssertionError(f"card and CPU surrogate scores differ: "
                             f"{ratio:.3g}x the tolerance")
    if not torch.isfinite(torch.tensor(best_q)):
        raise AssertionError(f"best_qor {best_q} is not finite")
    for what, pm in (("DE population", st.tstates[0].pop.perms[0]),
                     ("best", st.best.perms[0])):
        if not is_perm_rows(pm, N_CITIES):
            raise AssertionError(f"{what}: a tour is not a permutation")
    for vals, idx in tops:
        if (vals.shape != (TOP_K,) or not bool(torch.isfinite(vals).all())
                or not bool((vals[1:] <= vals[:-1]).all())
                or int(idx.min()) < 0 or int(idx.max()) >= eng.total_batch
                or int(torch.unique(idx).numel()) != TOP_K):
            raise AssertionError("propose_topk: a selection is not k "
                                 "distinct rows by descending utility")
    return out, st, ev, ev_mean, ev_ei


# -- the batched engine ----------------------------------------------------------
def row_of(tree, i: int):
    """Instance i of a stacked tree."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(row_of(x, i) for x in tree))
    if isinstance(tree, tuple):
        return tuple(row_of(x, i) for x in tree)
    return tree


def trees_differ(a, b) -> list:
    """The paths where two trees' tensors are not bitwise equal."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if sorted(la) != sorted(lb):
        return sorted(set(la) ^ set(lb))
    return [k for k in la if not torch.equal(col_bits(la[k].cpu()),
                                             col_bits(lb[k].cpu()))]


# CUDA runtime and driver calls that put work on the device
LAUNCH_CALL = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")
# the kernels of cuBLAS (products) and cuSOLVER (eigh), which pick among
# kernels by the size of a batch
LIBRARY_KERNEL = re.compile(r"gemm|gemv|sytrd|syev|stedc|ormtr|orgtr")


def profiled(fn):
    """fn() inside a torch.profiler window (CPU and CUDA activity), the
    device idle at both ends.  The window opens with SENTINELS empty
    kernels (the merge library's `launch_floor_kernel`) queued before
    fn(): the profiler loses the device records of the first one to three
    kernels of a window (the host's launch calls are all recorded), and
    these absorb the loss.  `device_events` and `launch_calls` leave
    them out."""
    from torch.profiler import ProfilerActivity, profile
    from uptune_tpu_torch import native
    floor = merge_library("ut_merge_launch_floor",
                          [ctypes.c_int] * 3 + [ctypes.c_void_p])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(SENTINELS):
            native.check(floor(1, 1, 32, stream), native.MERGE)
        fn()
        torch.cuda.synchronize()
    return prof


def device_events(prof) -> list:
    """The device events (kernels, copies, sets) of a `profiled` window,
    in order of start, without its sentinels."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and SENTINEL_KERNEL not in e.name),
                  key=lambda e: e.time_range.start)


def launch_calls(prof) -> int:
    """The host's calls that put work on the device in a `profiled`
    window, without its sentinels."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and LAUNCH_CALL.match(e.name)) - SENTINELS


def launch_counts(fn, steps: int, windows: int = 1) -> dict:
    """What fn() (`steps` batched steps) launches a step: CUDA kernels
    and copies by the profiler, and the ops torch dispatches (a
    TorchDispatchMode), over `windows` profiler windows on the same
    inputs.  Every launch call of the host puts one op on the device, so
    a window that records fewer device events than launch calls lost
    records in the profiler, not work on the card: it is set aside and
    retaken, up to RETAKES times in all.  `short_windows` says, for each
    window set aside, how many records it lacked, where they lie among a
    complete window's (in order of start) and what they are.  If too few
    windows are complete, the short ones are kept, and the caller's
    comparison of device ops with launch calls fails."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    kept, aside, calls = [], [], []
    while len(kept) < windows and len(calls) < windows + RETAKES:
        prof = profiled(fn)
        seq = [e.name for e in device_events(prof)]
        calls.append(launch_calls(prof))
        (kept if len(seq) == calls[-1] else aside).append(
            (len(calls) - 1, seq))
    ref = kept[0][1] if kept else max((q for _, q in aside), key=len)
    short = []
    for i, seq in aside:
        p = next((j for j, (x, y) in enumerate(zip(seq, ref)) if x != y),
                 min(len(seq), len(ref)))
        q = next((j for j, (x, y) in enumerate(zip(seq[p:][::-1],
                                                   ref[::-1])) if x != y),
                 len(seq) - p)
        short.append({"window": i, "missing": calls[i] - len(seq),
                      "first_missing_at": p, "of": len(ref),
                      "contiguous": p + q == len(seq),
                      "names": [(k[:90], c) for k, c in collections.Counter(
                          ref[p:len(ref) - q]).most_common(8)],
                      "launch_calls": calls[i]})
    if len(kept) < windows:
        kept += aside
    with Ops() as ops:
        fn()
    torch.cuda.synchronize()
    seqs = [q for _, q in kept]
    return {"device_ops_per_step": len(ref) / steps,
            "device_ops_per_window": [len(x) / steps for x in seqs],
            "launch_calls_per_window": [c / steps for c in calls],
            "short_windows": short,
            "dispatched_ops_per_step": sum(ops.n.values()) / steps,
            "dispatched": ops.n, "device_ops": collections.Counter(ref)}


def ops_differ(a: dict, b: dict) -> list:
    """The device kernels and dispatched ops whose counts differ between
    two `launch_counts` results: [(name, count in a, count in b)]."""
    out = []
    for key in ("device_ops", "dispatched"):
        for k in sorted(set(a[key]) | set(b[key])):
            if a[key].get(k, 0) != b[key].get(k, 0):
                out.append((k[:90], a[key].get(k, 0), b[key].get(k, 0)))
    return out


def batched_phase(dev) -> tuple:
    """The JAX package's multi-instance protocol on the port (see the
    module docstring), with the launch counts set to 0 just before each
    timed run and read just after."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import (BatchedEngine, FusedEngine,
                                         default_arms)
    from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space
    eng = FusedEngine(rosenbrock_space(16, -5.0, 5.0),
                      lambda v, p: rosenbrock_device(v),
                      arms=default_arms(1), history_capacity=MULTI_CAP,
                      device=dev)
    b = eng.total_batch
    out = {"phase": "batched", "space": "rosenbrock-16d [-5, 5]",
           "rows_per_instance": b, "history_capacity": MULTI_CAP,
           "instances": MULTI_N, "rows_per_step": MULTI_N * b,
           "steps": MULTI_STEPS, "runs": [], "launches_per_step": {}}
    # what a step launches at N = 4 and at N = 256: every step exchanges,
    # so the exchange is counted too
    counts = {}
    for n in (MULTI_SMALL_N, MULTI_N):
        be = BatchedEngine(eng, n, exchange_every=1)
        st = be.run(be.init(SEED), 2)
        counts[n] = launch_counts(lambda: be.run(st, 2), 2)
        out["launches_per_step"][n] = {
            k: v for k, v in counts[n].items()
            if k not in ("dispatched", "device_ops")}
    small, big = counts[MULTI_SMALL_N], counts[MULTI_N]
    # the one window kept at each N records a device op for each launch
    # call of the host
    same = (small["device_ops_per_step"] == big["device_ops_per_step"]
            and small["dispatched"] == big["dispatched"]
            and len(set(small["device_ops_per_window"]
                        + small["launch_calls_per_window"]
                        + big["launch_calls_per_window"])) == 1)
    out["launches_per_step"]["equal"] = same
    if not same:
        emit(out)
        raise AssertionError(
            f"a batched step launches {small['device_ops_per_step']} "
            f"kernels at N={MULTI_SMALL_N}, {big['device_ops_per_step']} "
            f"at N={MULTI_N}; dispatched ops differ: "
            f"{sorted(set(small['dispatched'].items()) ^ set(big['dispatched'].items()))[:8]}")
    # the yardstick: one instance's step on its own, as a loop over the
    # instances would take it
    single = eng.run(eng.init(SEED), 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(single, MULTI_SINGLE_STEPS)
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) / MULTI_SINGLE_STEPS
    out["single_instance_ms_per_step"] = one * 1e3
    final = None
    for every in (0, MULTI_EXCHANGE):
        be = BatchedEngine(eng, MULTI_N, exchange_every=every)
        st = be.run(be.init(SEED), 1)            # warm step
        torch.cuda.synchronize()
        native.reset_launches()                  # the run starts here
        t0 = time.perf_counter()
        # the exchange is the last step of this call (16, 32, 48)
        st = be.run(st, MULTI_STEPS - 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        q = st.best.qor
        exchanged = (bool((q == q.min()).all())
                     and bool((st.best.u == st.best.u[0]).all()))
        t2 = time.perf_counter()
        st = be.run(st, 2)
        torch.cuda.synchronize()
        wall = (t1 - t0) + (time.perf_counter() - t2)
        launches = {k.name: k.launches for k in native.KERNELS}
        run = {"exchange_every": every, "seconds": wall,
               "ms_per_step": wall / MULTI_STEPS * 1e3,
               "acquisitions_per_s": MULTI_N * b * MULTI_STEPS / wall,
               "speedup_vs_instance_loop": MULTI_N * one * MULTI_STEPS
               / wall,
               "best_qor": float(be.best_qors(st).min()),
               "evals": int(st.evals.sum()), "acqs": int(st.acqs.sum()),
               "hist_dropped": int(st.hist.dropped.sum()),
               "launches": launches}
        if every:
            run["all_equal_after_exchange"] = exchanged
        out["runs"].append(run)
        want = {k.name: 0 for k in native.KERNELS}
        want["merge_rows"] = MULTI_STEPS
        if launches != want:
            emit(out)
            raise AssertionError(f"batched launches {launches}, expected "
                                 f"{want}")
        if every and not exchanged:
            emit(out)
            raise AssertionError("after an exchanging step the instances' "
                                 "bests differ")
        h0 = st.hist.h0
        if (not np_all_finite(be.best_qors(st))
                or not bool((h0[:, 1:] >= h0[:, :-1]).all())
                or int(st.acqs.sum()) != MULTI_N * b * (MULTI_STEPS + 1)):
            emit(out)
            raise AssertionError("batched run: a best is not finite, a "
                                 "history is not sorted or rows are lost")
        final = (be, st)
    emit(out)
    return out, final


def np_all_finite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(a).all())


def batched_flagship_phase(cases, feats: tuple, dev) -> tuple:
    """The flagship over N instances, scored by launcher C on the flat
    batch (see the module docstring)."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import BatchedEngine, surrogate_eval_fn
    from uptune_tpu_torch.flagship import N_CITIES, flagship
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.space.spec import CandBatch
    from uptune_tpu_torch.surrogate import pallas_score as ps
    nc, ncat = feats
    st_gp, _, best, _, _ = cases["mixed_n1024"]
    eng = flagship(SCALE, history_capacity=CAPACITY, device=dev)
    ev = surrogate_eval_fn(eng.space, st_gp, kind="ei", best_y=best,
                           impl="fused", n_cont=nc, n_cat=ncat)
    be = BatchedEngine(eng, BF_N)
    seed = SEED + 7
    st0 = be.init(seed)
    be.run(st0, 1, eval_fn=ev)                   # warm step
    torch.cuda.synchronize()

    native.reset_launches()                      # the run starts here
    t0 = time.perf_counter()
    st = be.run(st0, BF_STEPS, eval_fn=ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in native.KERNELS}
    rows = BF_N * eng.total_batch
    out = {"phase": "batched_flagship", "scale": SCALE, "instances": BF_N,
           "rows_per_instance": eng.total_batch, "rows_per_step": rows,
           "history_capacity": CAPACITY, "steps": BF_STEPS,
           "seconds": wall, "ms_per_step": wall / BF_STEPS * 1e3,
           "acquisitions_per_s": rows * BF_STEPS / wall,
           "best_qor": float(be.best_qors(st).min()),
           "launches": launches,
           "acquire_scratch_bytes": 4 * ps.scratch_words(
               acq.SCORES_KERNEL, rows, int(st_gp.x.shape[0]), True)}
    want = {k.name: 0 for k in native.KERNELS}
    want.update(acquire_scores=BF_STEPS, merge_rows=BF_STEPS)
    bad = []
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if not np_all_finite(be.best_qors(st)):
        bad.append("a best is not finite")
    if not is_perm_rows(st.best.perms[0], N_CITIES):
        bad.append("a best tour is not a permutation")

    # C's scores of one flat batch on the card against the CPU's
    cpu = torch.device("cpu")
    tst, cands, keys = torch.func.vmap(eng.propose)(st)
    n, b = cands.u.shape[:2]
    flat = CandBatch(cands.u.reshape(n * b, -1),
                     tuple(p.reshape(n * b, -1) for p in cands.perms))
    got = ev.fn(flat, ev.aux)
    ref = ev.fn(tree_to(flat, cpu), tree_to(ev.aux, cpu))
    out["cpu_reference_max_abs_err"], ratio = tol_excess(
        got.cpu(), ref, SD_TOL, float(ev.aux[0].y_std))
    out["cpu_reference_err_over_tol"] = ratio
    if not ratio <= 1.0:
        bad.append(f"C's flat scores differ from the CPU's: {ratio:.3g}x "
                   f"the sd tolerance")

    # instance i of a batched run is a single run from instance_seeds[i]
    sb = be.run(st0, BF_MATCH_STEPS, eval_fn=ev)
    seeds = be.instance_seeds(seed)
    differ = {}
    for i in range(BF_N):
        si = eng.run(eng.init(seeds[i]), BF_MATCH_STEPS, eval_fn=ev)
        d = trees_differ(row_of(sb, i), si)
        if d:
            differ[i] = d[:6]
    out["matched_seed_steps"] = BF_MATCH_STEPS
    out["matched_seed_mismatches"] = differ
    if differ:
        bad.append(f"batched instances differ from single runs: {differ}")

    # one batched commit (with the exchange) on the card and on the CPU
    eng_c = flagship(SCALE, history_capacity=CAPACITY, device=cpu)
    space = eng.space
    tst, cands, keys = torch.func.vmap(eng.propose)(sb)
    flat = CandBatch(cands.u.reshape(n * b, -1),
                     tuple(p.reshape(n * b, -1) for p in cands.perms))
    flat_c = space.from_configs(space.to_configs(flat), device=cpu)
    raw_c = eng_c.evaluate(flat_c).reshape(n, b)
    cands_c = CandBatch(flat_c.u.reshape(n, b, -1),
                        tuple(p.reshape(n, b, -1) for p in flat_c.perms))
    out_g = be.commit(sb, tst, tree_to(cands_c, dev), raw_c.to(dev), keys,
                      exchange=True)
    out_c = BatchedEngine(eng_c, BF_N).commit(
        tree_to(sb, cpu), tree_to(tst, cpu), cands_c, raw_c, keys.cpu(),
        exchange=True)
    torch.cuda.synchronize()
    mism = trees_differ(out_g, out_c)
    out["commit_cpu_mismatched"] = mism
    out["commit_leaves"] = len(tree_leaves(out_c))
    if mism:
        bad.append(f"card and CPU batched commits differ at {mism[:6]}")
    emit(out)
    if bad:
        raise AssertionError("batched flagship: " + "; ".join(bad))
    return out, (be, st, ev)


def tf32_phase(cases, feats: tuple, dev) -> dict:
    """TF32 switched on globally, the main GP refitted from the same
    inputs: the fit and its scores against the TF32-off fit, at the mean
    and sd tolerances; and the setting as the caller left it.  At 31
    features cuBLAS may not take the tensor cores at all, so the same is
    done with the features padded by a zero lane to 32 (24 continuous,
    rows of 128 bytes), where an unpinned product does run in TF32: its
    distances are reported beside the pinned fit's, which must equal the
    TF32-off fit bitwise."""
    from uptune_tpu_torch.flagship import flagship_surrogate
    from uptune_tpu_torch.surrogate import gp
    nc, ncat = feats
    base, xq, best, _, _ = cases["mixed_n1024"]
    x, y, _ = flagship_surrogate(N_TRAIN, SEED + 1, dev)
    q = xq[:N_TRAIN]

    def pad(t):                      # a zero continuous lane: 32 features
        return torch.cat([t[:, :nc], torch.zeros_like(t[:, :1]),
                          t[:, nc:]], dim=1).contiguous()
    x32 = pad(x)

    def fit32():
        return gp.fit_auto_bucketed(x32, y, max_points=N_TRAIN,
                                    n_cont=nc + 1, n_cat=ncat)
    base32 = fit32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st = gp.precompute_kinv(gp.fit_auto_bucketed(
            x, y, max_points=N_TRAIN, n_cont=nc, n_cat=ncat))
        mu, sd = gp.predict(st, q, nc, ncat)
        ei = gp.score_flat(st, xq, kind="ei", best_y=best, n_cont=nc,
                           n_cat=ncat)
        st32 = fit32()
        kept = torch.backends.cuda.matmul.allow_tf32
        # what TF32 does to the distances where nothing pins them
        d2_tf32 = {f: gp._raw_d2(t, t) for f, t in
                   ((31, x[:, :nc]), (32, x32[:, :nc + 1]))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d2_f32 = {31: gp._raw_d2(x[:, :nc], x[:, :nc]),
              32: gp._raw_d2(x32[:, :nc + 1], x32[:, :nc + 1])}
    mu0, sd0 = gp.predict(base, q, nc, ncat)
    ei0 = gp.score_flat(base, xq, kind="ei", best_y=best, n_cont=nc,
                        n_cat=ncat)
    ys, ym = float(base.y_std), float(base.y_mean)
    out = {"phase": "tf32", "train_rows": N_TRAIN,
           "setting_kept": bool(kept),
           "hyperparameters_equal": bool(
               torch.equal(st.lengthscale, base.lengthscale)
               and torch.equal(st.noise, base.noise)
               and torch.equal(st.ls_cat, base.ls_cat)),
           "alpha_bitwise": bool(torch.equal(st.alpha, base.alpha)),
           "chol_bitwise": bool(torch.equal(st.chol, base.chol)),
           "f32_fit_bitwise": all(
               bool(torch.equal(getattr(st32, f), getattr(base32, f)))
               for f in ("alpha", "chol", "lengthscale", "noise",
                         "ls_cat")),
           "unpinned_d2_tf32_max_abs_err": {
               f"features_{f}": float((d2_tf32[f] - d2_f32[f]).abs().max())
               for f in d2_f32}}
    out["mean_max_abs_err"], out["mean_err_over_tol"] = tol_excess(
        mu, mu0, MEAN_TOL, ys, ym)
    out["sd_max_abs_err"], out["sd_err_over_tol"] = tol_excess(
        sd, sd0, SD_TOL, ys)
    # EI is held to the mean's tolerance plus the sd's (UTILITY_TOL)
    ei_tol = {k: MEAN_TOL[k] + SD_TOL[k] for k in MEAN_TOL}
    out["ei_max_abs_err"], out["ei_err_over_tol"] = tol_excess(
        ei, ei0, ei_tol, ys)
    emit(out)
    if not (out["setting_kept"] and out["hyperparameters_equal"]
            and out["f32_fit_bitwise"]
            and out["mean_err_over_tol"] <= 1 and out["sd_err_over_tol"] <= 1
            and out["ei_err_over_tol"] <= 1):
        raise AssertionError(f"the GP under a global TF32 setting: {out}")
    return out


# -- the portfolio paths ------------------------------------------------------
def sync_count(fn, depth: int = 1) -> dict:
    """The host-device synchronisations fn() makes (torch's sync debug
    mode warns once for each), counted by the innermost line of the port
    on the Python stack at the time (with `depth` > 1, the innermost
    `depth` lines, callee first: a helper's callers apart)."""
    import collections
    import traceback
    import warnings
    where = collections.Counter()
    pkg = str(ROOT / "uptune_tpu_torch")

    def hook(message, category, filename, lineno, file=None, line=None):
        # not the mode's own notice that it is a prototype
        if "called a synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        at = (" <- ".join(f"{Path(f.filename).relative_to(ROOT)}:"
                          f"{f.lineno}" for f in ours[::-1][:depth])
              if ours else f"{Path(filename).name}:{lineno}")
        where[at] += 1

    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    return dict(where)


def stored_tours_ok(tstates, n: int) -> bool:
    """Every permutation an arm's state stores is one of range(n)."""
    return all(is_perm_rows(leaf, n)
               for path, leaf in tree_leaves(tstates).items()
               if "perms" in path)


def portfolio_flagship_phase(cases, feats: tuple, dev) -> tuple:
    """The flagship under the portfolio arms (see the module docstring),
    with the launch counts set to 0 just before the timed run and read
    just after."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import surrogate_eval_fn
    from uptune_tpu_torch.flagship import N_CITIES, flagship_portfolio
    nc, ncat = feats
    st_gp, _, best_y, _, _ = cases["mixed_n1024"]
    eng = flagship_portfolio(PF_SCALE, history_capacity=CAPACITY,
                             device=dev)
    rows = eng.total_batch
    if rows != PF_ROWS:
        raise AssertionError(f"scale {PF_SCALE} gives {rows} rows a step, "
                             f"not {PF_ROWS}")
    ev = surrogate_eval_fn(eng.space, st_gp, kind="ei", best_y=best_y,
                           impl="fused", n_cont=nc, n_cat=ncat)
    st = eng.step(eng.step(eng.init(seed=SEED + 8)), eval_fn=ev)   # warm
    torch.cuda.synchronize()

    native.reset_launches()                 # the main path's run starts here
    t0 = time.perf_counter()
    for _ in range(PF_STEPS):
        st = eng.step(st)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(PF_SCORED):
        st = eng.step(st, eval_fn=ev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.name: k.launches for k in native.KERNELS}

    best = eng.best_qor(st)
    out = {"phase": "portfolio_flagship", "scale": PF_SCALE,
           "rows_per_step": rows, "arms": [t.name for t in eng.arms],
           "rows_per_arm": eng.batches, "history_capacity": CAPACITY,
           "plain_steps": PF_STEPS,
           "plain_ms_per_step": (t1 - t0) / PF_STEPS * 1e3,
           "plain_acquisitions_per_s": rows * PF_STEPS / (t1 - t0),
           "scored_steps": PF_SCORED, "kind": "ei",
           "scored_ms_per_step": (t2 - t1) / PF_SCORED * 1e3,
           "scored_acquisitions_per_s": rows * PF_SCORED / (t2 - t1),
           "best_qor": best, "evals": int(st.evals), "acqs": int(st.acqs),
           "hist_dropped": int(st.hist.dropped), "launches": launches,
           "syncs_per_step": sync_count(lambda: eng.step(st)),
           "syncs_per_scored_step": sync_count(
               lambda: eng.step(st, eval_fn=ev))}
    bad = []
    want = {k.name: 0 for k in native.KERNELS}
    want.update(merge_rows=PF_STEPS + PF_SCORED, acquire_scores=PF_SCORED)
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if not torch.isfinite(torch.tensor(best)):
        bad.append(f"best_qor {best} is not finite")
    cands = eng.propose(st)[1]
    if not (stored_tours_ok(st.tstates, N_CITIES)
            and is_perm_rows(st.best.perms[0], N_CITIES)
            and is_perm_rows(cands.perms[0], N_CITIES)):
        bad.append("a tour is not a permutation")
    # C's scores of one proposal (this path's 6104 rows) on the card
    # against the CPU's
    cpu = torch.device("cpu")
    got = ev.fn(cands, ev.aux)
    ref = ev.fn(tree_to(cands, cpu), tree_to(ev.aux, cpu))
    out["cpu_reference_max_abs_err"], ratio = tol_excess(
        got.cpu(), ref, SD_TOL, float(ev.aux[0].y_std))
    out["cpu_reference_err_over_tol"] = ratio
    if not ratio <= 1.0:
        bad.append(f"C's scores differ from the CPU's: {ratio:.3g}x the "
                   f"sd tolerance")
    # one commit on the card and on the CPU: every op exact, bitwise
    eng_c = flagship_portfolio(PF_SCALE, history_capacity=CAPACITY,
                               device=cpu)
    out_g, out_c = commit_on_cpu(eng, eng_c, st, dev)
    mism = trees_differ(out_g, out_c)
    out["commit_leaves"] = len(tree_leaves(out_c))
    out["commit_cpu_mismatched"] = mism
    if mism:
        bad.append(f"card and CPU commits differ at {mism[:6]}")
    emit(out)
    if bad:
        raise AssertionError("portfolio flagship: " + "; ".join(bad))
    return out, (eng, st, ev)


def batched_portfolio_engine(dev):
    """rosenbrock-16d in [-5, 5] under the AUCBanditMetaTechniqueTPU
    members and five more arms, a 2^11-row history, on `dev`."""
    from uptune_tpu_torch.engine import FusedEngine
    from uptune_tpu_torch.techniques import get_root
    from uptune_tpu_torch.workloads import rosenbrock_device, rosenbrock_space
    arms = list(get_root(["AUCBanditMetaTechniqueTPU"]).techniques)
    arms += [get_root([n]) for n in (
        "PatternSearch", "PseudoAnnealingSearch", "RegularTorczon",
        "AUCBanditMutationTechnique", "MultiNelderMead")]
    return FusedEngine(rosenbrock_space(16, -5.0, 5.0),
                       lambda v, p: rosenbrock_device(v), arms=arms,
                       history_capacity=MULTI_CAP, device=dev)


def cma_leaves_ok(a, b, prefix: str) -> tuple:
    """CMA-ES's state in two trees (the card's and the CPU's) under
    `prefix`: (bitwise paths, paths beyond CMA_TOL).  The basis is held
    through B diag(lambda) B^T, every float leaf to CMA_TOL, the
    generation bitwise."""
    la, lb = tree_leaves(a), tree_leaves(b)
    keys = [k for k in la if k.startswith(prefix)]
    bitwise, beyond = [], []
    for k in keys:
        x, y = la[k].cpu(), lb[k].cpu()
        if torch.equal(col_bits(x), col_bits(y)):
            bitwise.append(k)
            continue
        if k.endswith("eig_b"):
            sq = k[:-len("eig_b")] + "eig_sq"
            x = (x * la[sq].cpu()[..., None, :] ** 2) @ x.mT
            y = (y * lb[sq].cpu()[..., None, :] ** 2) @ y.mT
        if (not x.is_floating_point()
                or not torch.allclose(x, y, **CMA_TOL)):
            beyond.append(k)
    return bitwise, beyond


def portfolio_batched_phase(dev) -> tuple:
    """The multi-instance protocol under the portfolio arms (see the
    module docstring), with the launch counts set to 0 just before the
    timed run and read just after."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import BatchedEngine
    from uptune_tpu_torch.space.spec import CandBatch
    eng = batched_portfolio_engine(dev)
    b = eng.total_batch
    if b != PB_ROWS:
        raise AssertionError(f"{b} rows an instance, not {PB_ROWS}")
    out = {"phase": "portfolio_batched", "space": "rosenbrock-16d [-5, 5]",
           "arms": [t.name for t in eng.arms], "rows_per_arm": eng.batches,
           "rows_per_instance": b, "history_capacity": MULTI_CAP,
           "instances": PB_N, "rows_per_step": PB_N * b, "steps": PB_STEPS,
           "exchange_every": MULTI_EXCHANGE, "launches_per_step": {}}
    bad = []
    # what a step launches at N = 4 and at N = 256 (every step exchanges)
    counts = {}
    for n in (MULTI_SMALL_N, PB_N):
        be = BatchedEngine(eng, n, exchange_every=1)
        st = be.run(be.init(SEED), 2)
        counts[n] = launch_counts(lambda: be.run(st, 2), 2, COUNT_WINDOWS)
        out["launches_per_step"][n] = {
            k: v for k, v in counts[n].items()
            if k not in ("dispatched", "device_ops")}
    small, big = counts[MULTI_SMALL_N], counts[PB_N]
    # every window kept at both N records the same device ops, one for
    # each launch call of the host, and every window taken (those set
    # aside too) makes the same launch calls
    per = small["device_ops_per_window"] + big["device_ops_per_window"]
    calls = small["launch_calls_per_window"] + big["launch_calls_per_window"]
    same = (small["dispatched"] == big["dispatched"]
            and len(set(per + calls)) == 1)
    out["launches_per_step"]["equal"] = same
    # cuBLAS and cuSOLVER pick other kernels of one count for other
    # batch sizes (the float64 products, eigh's tridiagonalization);
    # every other kernel's count is equal at both N
    differ = ops_differ(small, big)
    out["launches_per_step"]["kernels_named_otherwise"] = differ[:12]
    ours = [d for d in differ if not LIBRARY_KERNEL.search(d[0])]
    if ours:
        bad.append(f"kernels outside cuBLAS and cuSOLVER launch other "
                   f"counts at N={MULTI_SMALL_N} and N={PB_N}: {ours[:8]}")
    if not same:
        bad.append(f"a step's ops differ between N={MULTI_SMALL_N} and "
                   f"N={PB_N} or between windows: device {per}, launch "
                   f"calls {calls}; {ops_differ(small, big)[:8]}")

    be = BatchedEngine(eng, PB_N, exchange_every=MULTI_EXCHANGE)
    st = be.run(be.init(SEED + 9), 1)            # warm step
    torch.cuda.synchronize()
    native.reset_launches()                      # the run starts here
    t0 = time.perf_counter()
    st = be.run(st, MULTI_EXCHANGE)              # exchanges at its last step
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    q = st.best.qor
    exchanged = (bool((q == q.min()).all())
                 and bool((st.best.u == st.best.u[0]).all()))
    t2 = time.perf_counter()
    st = be.run(st, PB_STEPS - MULTI_EXCHANGE)
    torch.cuda.synchronize()
    wall = (t1 - t0) + (time.perf_counter() - t2)
    launches = {k.name: k.launches for k in native.KERNELS}
    out.update({
        "seconds": wall, "ms_per_step": wall / PB_STEPS * 1e3,
        "acquisitions_per_s": PB_N * b * PB_STEPS / wall,
        "best_qor": float(be.best_qors(st).min()),
        "evals": int(st.evals.sum()), "acqs": int(st.acqs.sum()),
        "hist_dropped": int(st.hist.dropped.sum()), "launches": launches,
        "all_equal_after_exchange": exchanged,
        "syncs_per_step": sync_count(lambda: be.run(st, 1))})
    want = {k.name: 0 for k in native.KERNELS}
    want["merge_rows"] = PB_STEPS
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if not exchanged:
        bad.append("after an exchanging step the instances' bests differ")
    h0 = st.hist.h0
    if (not np_all_finite(be.best_qors(st))
            or not bool((h0[:, 1:] >= h0[:, :-1]).all())
            or int(st.acqs.sum()) != PB_N * b * (PB_STEPS + 1)):
        bad.append("a best is not finite, a history is not sorted or rows "
                   "are lost")

    # instances of an unexchanged run equal single card runs
    be0 = BatchedEngine(eng, PB_N)
    seed = SEED + 10
    sb = be0.run(be0.init(seed), PB_MATCH_STEPS)
    seeds = be0.instance_seeds(seed)
    differ = {}
    for i in PB_MATCH:
        d = trees_differ(row_of(sb, i),
                         eng.run(eng.init(seeds[i]), PB_MATCH_STEPS))
        if d:
            differ[i] = d[:6]
    out["matched_seed_steps"] = PB_MATCH_STEPS
    out["matched_seed_instances"] = list(PB_MATCH)
    out["matched_seed_mismatches"] = differ
    if differ:
        bad.append(f"batched instances differ from single runs: {differ}")

    # one batched commit (with the exchange) on the card and on the CPU;
    # float lanes hash on a grid of u alone, so no codec snap is needed
    cpu = torch.device("cpu")
    eng_c = batched_portfolio_engine(cpu)
    tst, cands, keys = torch.func.vmap(eng.propose)(sb)
    n, nb = cands.u.shape[:2]
    cands_c = tree_to(cands, cpu)
    raw_c = eng_c.evaluate(CandBatch(cands_c.u.reshape(n * nb, -1), ())
                           ).reshape(n, nb)
    out_g = be0.commit(sb, tst, tree_to(cands_c, dev), raw_c.to(dev), keys,
                       exchange=True)
    out_c = BatchedEngine(eng_c, PB_N).commit(
        tree_to(sb, cpu), tree_to(tst, cpu), cands_c, raw_c, keys.cpu(),
        exchange=True)
    torch.cuda.synchronize()
    ci = [type(t).__name__ for t in eng.arms].index("CMAES")
    prefix = f"state.tstates[{ci}]."
    mism = [k for k in trees_differ(out_g, out_c)
            if not k.startswith(prefix)]
    cma_bitwise, cma_beyond = cma_leaves_ok(out_g, out_c, prefix)
    out["commit_leaves"] = len(tree_leaves(out_c))
    out["commit_cpu_mismatched"] = mism
    out["commit_cma_bitwise"] = [k[len(prefix):] for k in cma_bitwise]
    out["commit_cma_beyond_tol"] = cma_beyond
    if mism or cma_beyond:
        bad.append(f"card and CPU batched commits differ at "
                   f"{(mism + cma_beyond)[:6]}")
    emit(out)
    if bad:
        raise AssertionError("portfolio batched: " + "; ".join(bad))
    return out, (be, st)


# -- the ask/tell driver -------------------------------------------------------
def driver_tuner(dev, cap: int, seed: int, archive=None, **kw):
    """A Tuner on the flagship's space with the flagship's host objective
    on `dev`, the default portfolio and history of `cap` rows (and any
    further Tuner arguments `kw`): (tuner, its StepStats, its commit
    count).  The commits are counted around `Tuner._commit`, the one
    place a ticket merges into the history."""
    from uptune_tpu_torch.driver import Tuner
    from uptune_tpu_torch.driver.plugins import SearchHook
    from uptune_tpu_torch.flagship import (flagship_host_objective,
                                           flagship_space)

    class Steps(SearchHook):
        def __init__(self):
            self.stats = []

        def on_step(self, tuner, stats):
            self.stats.append(stats)
    rec = Steps()
    t = Tuner(flagship_space(), flagship_host_objective(dev), seed=seed,
              capacity=cap, archive=archive, hooks=[rec], device=dev, **kw)
    commits = [0]
    commit = t._commit

    def counted(*args):
        commits[0] += 1
        commit(*args)
    t._commit = counted
    return t, rec.stats, commits


def live_rows(hist) -> torch.Tensor:
    """A history's live rows as [n, 3] int64 (h0, h1, qor's bits), in
    (h0, h1) order: what dedup and the known-QoR lookup see."""
    h0, h1, q, age = (x.cpu() for x in (hist.h0, hist.h1, hist.qor,
                                        hist.age))
    live = age >= 0
    rows = torch.stack([h0[live], h1[live], col_bits(q[live])], dim=1)
    order = torch.sort(rows[:, 1], stable=True).indices
    rows = rows[order]
    return rows[torch.sort(rows[:, 0], stable=True).indices]


def driver_phase(dev) -> tuple:
    """The Tuner on the card (see the module docstring), with the launch
    counts set to 0 just before the timed tune and read just after."""
    import collections
    import random
    import tempfile
    import numpy as np
    from uptune_tpu_torch import native
    from uptune_tpu_torch.driver import Tuner
    from uptune_tpu_torch.driver.history import History
    from uptune_tpu_torch.flagship import (N_CITIES, flagship_host_objective,
                                           flagship_space)
    from uptune_tpu_torch.space.spec import CandBatch
    cpu = torch.device("cpu")
    space = flagship_space()
    work = tempfile.TemporaryDirectory(prefix="ut_driver_")
    arc = str(Path(work.name) / "card.jsonl")
    bad = []
    warm, _, _ = driver_tuner(dev, DRIVER_CAP, SEED + 20)
    warm.run(test_limit=DRIVER_WARM)
    torch.cuda.synchronize()

    t, stats, commits = driver_tuner(dev, DRIVER_CAP, SEED + 21, arc)
    native.reset_launches()                 # the main path's run starts here
    t0 = time.perf_counter()
    res = t.run(test_limit=DRIVER_LIMIT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in native.KERNELS}
    tickets = res.steps
    out = {"phase": "driver", "space": "flagship",
           "technique": t.root.name,
           "rows_per_arm": {m.name: t._nb[m.name] for m in t.members},
           "bucket": t._bucket, "history_capacity": DRIVER_CAP,
           "test_limit": DRIVER_LIMIT, "tickets": tickets,
           "evals": res.evals, "seconds": wall,
           "ms_per_ticket": wall / tickets * 1e3,
           "evals_per_s": res.evals / wall,
           "t_propose_median_ms": statistics.median(
               s.t_propose for s in stats) * 1e3,
           "t_dedup_median_ms": statistics.median(
               s.t_dedup for s in stats) * 1e3,
           "pulls": dict(collections.Counter(s.technique for s in stats)),
           "commits": commits[0], "launches": launches,
           "best_qor": res.best_qor,
           "hist_dropped": int(t.hist_state.dropped)}
    want = {k.name: 0 for k in native.KERNELS}
    want["merge_rows"] = commits[0]
    if launches != want or not commits[0]:
        bad.append(f"launches {launches}, expected {want}")
    if t._bucket != DRIVER_B:
        bad.append(f"dedup bucket {t._bucket}, not {DRIVER_B}")
    if out["hist_dropped"]:
        bad.append(f"{out['hist_dropped']} history rows evicted")
    if not np.isfinite(res.best_qor):
        bad.append(f"best_qor {res.best_qor} is not finite")

    # host syncs and device ops a ticket, over further tickets
    def tickets_of(n):
        return lambda: [t.step() for _ in range(n)]
    out["syncs_per_ticket"] = {
        k: v / COUNT_TICKETS
        for k, v in sync_count(tickets_of(COUNT_TICKETS), 2).items()}
    counts = launch_counts(tickets_of(COUNT_TICKETS), COUNT_TICKETS)
    out["device_ops_per_ticket"] = counts["device_ops_per_step"]
    out["launch_calls_per_ticket"] = counts["launch_calls_per_window"]
    out["dispatched_ops_per_ticket"] = counts["dispatched_ops_per_step"]
    out["top_device_ops"] = [(k[:90], c / COUNT_TICKETS) for k, c in
                             counts["device_ops"].most_common(12)]

    # no configuration evaluated twice; every stored tour a permutation
    t._flush_archive()
    rows = [json.loads(x) for x in open(arc)][1:]
    u = torch.tensor([r["u"] for r in rows], dtype=torch.float32)
    tours = torch.tensor([r["perms"][0] for r in rows], dtype=torch.int64)
    packed = Tuner._pack_hashes(
        space.hash_batch(CandBatch(u, (tours,))).numpy())
    out["archive_rows"] = len(rows)
    out["archive_unique_hashes"] = int(np.unique(packed).size)
    if not len(rows) == out["archive_unique_hashes"] == t.evals:
        bad.append(f"{len(rows)} archive rows, {out['archive_unique_hashes']}"
                   f" distinct hashes, {t.evals} evals")
    if not (stored_tours_ok(tuple(t._tstates.values()), N_CITIES)
            and is_perm_rows(t.best.perms[0], N_CITIES)
            and is_perm_rows(tours, N_CITIES)):
        bad.append("a tour is not a permutation")

    # the same tune on the CPU, in this process
    tc, _, _ = driver_tuner(cpu, DRIVER_CAP, SEED + 21)
    t0 = time.perf_counter()
    rc = tc.run(test_limit=DRIVER_LIMIT)
    wall_c = time.perf_counter() - t0
    out["cpu"] = {"tickets": rc.steps, "evals": rc.evals,
                  "seconds": wall_c, "ms_per_ticket": wall_c / rc.steps * 1e3,
                  "evals_per_s": rc.evals / wall_c, "best_qor": rc.best_qor}

    # a CPU tuner resumes the card's archive: the same live history rows,
    # best, evals and trace, bitwise
    tr = Tuner(space, None, capacity=DRIVER_CAP, archive=arc, resume=True,
               device="cpu")
    same_rows = torch.equal(live_rows(t.hist_state), live_rows(tr.hist_state))
    out["cpu_resume"] = {
        "live_rows": int((t.hist_state.age >= 0).sum()),
        "rows_equal": same_rows,
        "best_equal": tr._best_q == t._best_q,
        "evals_equal": tr.evals == t.evals,
        "trace_equal": tr.trace == t.trace}
    if not all(out["cpu_resume"][k] for k in (
            "rows_equal", "best_equal", "evals_equal", "trace_equal")):
        bad.append(f"the CPU resume differs: {out['cpu_resume']}")
    tr.close()

    # eviction inside real commits; one commit replayed on the CPU
    te, _, commits_e = driver_tuner(dev, EVICT_CAP, SEED + 22)
    native.reset_launches()
    rese = te.run(test_limit=EVICT_LIMIT)
    torch.cuda.synchronize()
    evict = {"history_capacity": EVICT_CAP, "test_limit": EVICT_LIMIT,
             "tickets": rese.steps, "evals": rese.evals,
             "commits": commits_e[0],
             "merge_launches": native.MERGE.launches,
             "hist_dropped": int(te.hist_state.dropped)}
    seen = {}
    commit = te._commit

    def capture(hashes, cands, qor, newly):
        seen.update(pre=(te.hist_state, te.best),
                    args=(hashes, cands, qor, newly))
        commit(hashes, cands, qor, newly)
        seen["post"] = (te.hist_state, te.best)
    te._commit = capture
    while "post" not in seen:
        te.step()
    (hist, best), (hashes, cands, qor, newly) = seen["pre"], seen["args"]
    hist_c = History(EVICT_CAP, device=cpu).insert(
        tree_to(hist, cpu), hashes.cpu(), qor.cpu(), newly.cpu())
    best_c = tree_to(best, cpu).update(tree_to(cands, cpu), qor.cpu())
    evict["commit_evicted"] = int(seen["post"][0].dropped - hist.dropped)
    evict["commit_cpu_mismatched"] = trees_differ(seen["post"],
                                                  (hist_c, best_c))
    out["evict"] = evict
    if (evict["merge_launches"] != evict["commits"]
            or not evict["hist_dropped"] or not evict["commit_evicted"]
            or evict["commit_cpu_mismatched"]):
        bad.append(f"eviction on the card: {evict}")

    # ask/tell: one ask of 256 trials, told in a seeded shuffled order,
    # one ticket fully and one partly cancelled
    ta, _, _ = driver_tuner(dev, DRIVER_CAP, SEED + 23)
    for _ in range(5):
        ta.step()
    evals0 = ta.evals
    trials = ta.ask(min_trials=ASK_TRIALS)
    tickets_a = list(dict.fromkeys(tr.ticket for tr in trials))
    arm_tickets = [tk for tk in tickets_a if not tk.injected]
    keys = [int(tr.ticket.packed[tr.row]) for tr in trials]
    ask = {"trials": len(trials), "tickets": len(tickets_a),
           "distinct_hashes": len(set(keys)),
           "pending": len(ta._pending)}
    if len(arm_tickets) < 2:
        bad.append(f"ask({ASK_TRIALS}) opened {len(arm_tickets)} arm "
                   f"tickets")
    else:
        full, part = arm_tickets[0], arm_tickets[1]
        current, observed, credited = [None], [], []
        finalize = ta._finalize

        def finalizing(tk):
            current[0] = tk
            try:
                return finalize(tk)
            finally:
                current[0] = None
        ta._finalize = finalizing
        for m in ta.members:
            def observing(*args, _observe=m.observe, **kw):
                observed.append(current[0])
                return _observe(*args, **kw)
            m.observe = observing
        credit = ta.root.credit

        def crediting(*args, **kw):
            credited.append(current[0])
            return credit(*args, **kw)
        ta.root.credit = crediting
        vals = flagship_host_objective(dev)([tr.config for tr in trials])
        order = list(range(len(trials)))
        random.Random(SEED).shuffle(order)
        told = 0
        for i in order:
            tr = trials[i]
            if tr.ticket is full or (tr.ticket is part and tr.slot % 2):
                ta.cancel(tr)
            else:
                ta.tell(tr, float(vals[i]))
                told += 1
        ask.update(told=told, evals=ta.evals - evals0,
                   cancelled=len(trials) - told,
                   withdrawn_observed=any(tk is full for tk in observed),
                   withdrawn_credited=any(tk is full for tk in credited),
                   partial_observed=any(tk is part for tk in observed),
                   pending_after=len(ta._pending))
        if (ask["distinct_hashes"] != len(trials)
                or ask["pending"] != len(trials) or ask["evals"] != told
                or ask["withdrawn_observed"] or ask["withdrawn_credited"]
                or not ask["partial_observed"] or ask["pending_after"]):
            bad.append(f"ask/tell: {ask}")
    out["ask_tell"] = ask
    emit(out)
    work.cleanup()
    if bad:
        raise AssertionError("driver: " + "; ".join(bad))
    return out, t


# -- the surrogate manager on the driver -----------------------------------------
def surrogate_tuner(dev, kind: str, opts: dict, seed: int, arc=None):
    """A Tuner on the flagship whose surrogate is the port's manager of
    `kind` with `opts` (see `driver_tuner`)."""
    return driver_tuner(dev, DRIVER_CAP, seed, arc, surrogate=kind,
                        surrogate_opts=opts)


def surrogate_run(t, stats, commits, limit: int, bad: list) -> dict:
    """`t.run(test_limit=limit)` with the launch counts set to 0 just
    before and read just after; the manager's counters; snapshot versions
    that never went down."""
    import numpy as np
    from uptune_tpu_torch import native
    dev = t.device
    native.reset_launches()
    t0 = time.perf_counter()
    res = t.run(test_limit=limit)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    sm = t.surrogate
    out = {"kind": sm.kind, "device": str(dev), "test_limit": limit,
           "tickets": res.steps, "evals": res.evals, "seconds": wall,
           "ms_per_ticket": wall / res.steps * 1e3,
           "evals_per_s": res.evals / wall,
           "t_propose_median_ms": statistics.median(
               s.t_propose for s in stats) * 1e3,
           "t_dedup_median_ms": statistics.median(
               s.t_dedup for s in stats) * 1e3,
           "commits": commits[0],
           "launches": {k.name: k.launches for k in native.KERNELS},
           "best_qor": res.best_qor,
           "refits_started": sm.refits_started,
           "refits_published": sm.refits, "extensions": sm.incr_updates,
           "blocking_refit_s": sm.t_refit_total,
           "background_refit_s": sm.t_refit_bg_total,
           "rows_pruned": t.pruned_total,
           "surrogate_tickets": t.arm_stats.get("surrogate", [0])[0],
           "snapshot_version": sm.snapshot_version}
    versions = [s.snapshot_version for s in stats]
    if any(b < a for a, b in zip(versions, versions[1:])):
        bad.append(f"{sm.kind} on {dev}: a snapshot version went down")
    if not np.isfinite(res.best_qor):
        bad.append(f"{sm.kind} on {dev}: best_qor {res.best_qor}")
    return out


def archive_ok(t, arc: str, n_cities: int) -> dict:
    """No configuration evaluated twice (the archive's hashes unique, one
    row an evaluation); every stored tour a permutation."""
    import numpy as np
    from uptune_tpu_torch.driver import Tuner
    from uptune_tpu_torch.space.spec import CandBatch
    t._flush_archive()
    rows = [json.loads(x) for x in open(arc)][1:]
    u = torch.tensor([r["u"] for r in rows], dtype=torch.float32)
    tours = torch.tensor([r["perms"][0] for r in rows], dtype=torch.int64)
    packed = Tuner._pack_hashes(
        t.space.hash_batch(CandBatch(u, (tours,))).numpy())
    return {"archive_rows": len(rows),
            "unique_hashes": int(np.unique(packed).size),
            "archive_evals": t.evals,
            "tours_ok": stored_tours_ok(tuple(t._tstates.values()), n_cities)
            and is_perm_rows(t.best.perms[0], n_cities)
            and is_perm_rows(tours, n_cities)}


def posterior_excess(a, b, xq, nc: int, ncat: int) -> dict:
    """GP state `a` against `b` on queries `xq`: the posterior mean and
    sd over their tolerances, in b's standardized units."""
    from uptune_tpu_torch.surrogate import gp
    ma, sa = gp.predict(a, xq.to(a.x.device, a.x.dtype), nc, ncat)
    mb, sb = gp.predict(b, xq.to(b.x.device, b.x.dtype), nc, ncat)
    ys, ym = float(b.y_std), float(b.y_mean)
    out = {"hyperparameters_equal": all(
        float(getattr(a, f)) == float(getattr(b, f))
        for f in ("lengthscale", "noise", "ls_cat"))}
    out["mean_max_abs_err"], out["mean_err_over_tol"] = tol_excess(
        ma.cpu(), mb.cpu(), MEAN_TOL, ys, ym)
    out["sd_max_abs_err"], out["sd_err_over_tol"] = tol_excess(
        sa.cpu(), sb.cpu(), SD_TOL, ys)
    return out


def gp_f64(st, y: torch.Tensor, nc: int, ncat: int):
    """GP state `st` refitted in float64 on the CPU from its own rows,
    mask and hyperparameters and the raw targets `y` it was fitted to,
    standardised as `st` was."""
    from uptune_tpu_torch.surrogate import gp
    s = tree_to(st, torch.device("cpu"))
    m = s.mask.double()
    f = gp.fit(s.x.double(), y.double(), s.lengthscale.double(),
               s.noise.double(), mask=m, n_cont=nc, n_cat=ncat,
               ls_cat=torch.as_tensor(s.ls_cat).double())
    yc = torch.where(torch.isfinite(y) & (m > 0), y.double(),
                     y.double()[torch.isfinite(y) & (m > 0)].max())
    yn = (yc - s.y_mean.double()) / s.y_std.double() * m
    return f._replace(alpha=torch.cholesky_solve(yn[:, None], f.chol)[:, 0],
                      y_mean=s.y_mean.double(), y_std=s.y_std.double())


def surrogate_driver_phase(dev) -> tuple:
    """The Tuner with the port's surrogate manager on the card (see the
    module docstring): the calibrated GP manager with async refits, the
    fused top-k's pool, the MLP ensemble, and a refit on the card against
    the CPU's.  -> (the phase's line, the calibrated tuner)."""
    import tempfile
    import numpy as np
    from uptune_tpu_torch import native, rng
    from uptune_tpu_torch.calibrated import CALIBRATED_OPTS
    from uptune_tpu_torch.flagship import N_CITIES
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import manager as man
    from uptune_tpu_torch.surrogate import mlp
    from uptune_tpu_torch.surrogate import pallas_score as ps
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    work = tempfile.TemporaryDirectory(prefix="ut_surrogate_")
    bad = []
    out = {"phase": "surrogate_driver",
           "tolerances": {"mean": MEAN_TOL, "sd": SD_TOL,
                          "mlp_predictions_over_y_std": MLP_TOL_Y_STD}}

    def kernels_want(merges, topk=0):
        want = {k.name: 0 for k in native.KERNELS}
        want["merge_rows"], want["acquire_topk"] = merges, topk
        return want

    # 1. calibrated, async refits, under the caller's TF32 setting
    arc = str(Path(work.name) / "calibrated.jsonl")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    setting = torch.get_float32_matmul_precision()
    try:
        t, stats, commits = surrogate_tuner(
            dev, "gp", {**CALIBRATED_OPTS, "async_refit": True}, SEED + 30,
            arc)
        cal = surrogate_run(t, stats, commits, SD_LIMIT, bad)
        sm = t.surrogate
        cal["pool_rows"] = sm._pool_geo.pool
        if cal["launches"] != kernels_want(commits[0]) or not commits[0]:
            bad.append(f"calibrated launches {cal['launches']}, expected "
                       f"{kernels_want(commits[0])}")
        cal["syncs_per_ticket"] = {
            k: v / COUNT_TICKETS for k, v in sync_count(
                lambda: [t.step() for _ in range(COUNT_TICKETS)],
                2).items()}
        sm.drain()
        cal["published_finite"] = all(bool(torch.isfinite(x).all())
                                      for x in man._leaves(sm._snap.state))
        cal["tf32_setting_kept"] = (
            torch.get_float32_matmul_precision() == setting
            and torch.backends.cuda.matmul.allow_tf32)
        # one refit under the caller's TF32, one without: equal fits
        args = sm._refit_args()
        sm._refit_full(*args)
        on = sm._snap.state
        torch.backends.cuda.matmul.allow_tf32 = False
        sm._refit_full(*args)
        off = sm._snap.state
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    xq = torch.from_numpy(np.stack(sm._xs[:512])).to(dev)
    cal["tf32_refit"] = posterior_excess(on, off, xq, sm._n_cont, sm._n_cat)
    cal.update(archive_ok(t, arc, N_CITIES))
    t.close()
    if not (cal["published_finite"] and cal["tf32_setting_kept"]
            and cal["tours_ok"] and cal["archive_rows"]
            == cal["unique_hashes"] == cal["archive_evals"]
            and cal["tf32_refit"]["hyperparameters_equal"]
            and cal["tf32_refit"]["mean_err_over_tol"] <= 1
            and cal["tf32_refit"]["sd_err_over_tol"] <= 1):
        bad.append(f"calibrated run: {cal}")
    out["calibrated"] = cal
    nc, ncat = sm._n_cont, sm._n_cat

    # the same tune on the CPU, in this process (sync refits); its rows,
    # the same in every run (the card's async run's depend on timing),
    # feed the card-against-CPU refit below
    tc, stats_c, commits_c = surrogate_tuner(cpu, "gp", CALIBRATED_OPTS,
                                             SEED + 30)
    out["calibrated_cpu"] = surrogate_run(tc, stats_c, commits_c, SD_LIMIT,
                                          bad)
    rows_x = np.stack(tc.surrogate._xs)
    rows_y = np.asarray(tc.surrogate._ys, np.float32)
    xq_refit = torch.from_numpy(rows_x[:512])
    tc.close()

    # 2. the fused top-k's pool (4096 rows), sync refits: D once a pool
    # pull, held against its plain version at every published snapshot
    # a pull ranked against
    t2, stats2, commits2 = surrogate_tuner(
        dev, "gp", {**CALIBRATED_OPTS, **SD_POOL}, SEED + 31)
    sm2 = t2.surrogate
    pulls, caps, grown = [0], {}, set()
    rank, extend = sm2._rank_pool, sm2._maybe_extend

    def ranking(state, cands, best_y):
        pulls[0] += 1
        caps.setdefault(sm2._snap.version, (state, cands, best_y,
                                            sm2._snap))
        return rank(state, cands, best_y)

    def extending():
        rows = extend()
        if rows:
            grown.add(sm2._snap.version)
        return rows
    sm2._rank_pool, sm2._maybe_extend = ranking, extending
    big = surrogate_run(t2, stats2, commits2, SD_POOL_LIMIT, bad)
    big["pool_rows"], big["pool_pulls"] = sm2._pool_geo.pool, pulls[0]
    if (big["launches"] != kernels_want(commits2[0], pulls[0])
            or not pulls[0] or big["pool_rows"] != 4096):
        bad.append(f"large-pool launches {big['launches']}, expected "
                   f"{kernels_want(commits2[0], pulls[0])}")
    # the run's first ticket brings ~31 rows, past the 32-row bucket: a
    # manager fitted on its first 16 rows (as a preload leaves it) ranks
    # one pool at N 32
    m32 = man.SurrogateManager(t2.space, "gp", device=dev,
                               **{**CALIBRATED_OPTS, **SD_POOL})
    m32._xs, m32._ys = list(sm2._xs[:16]), list(sm2._ys[:16])
    m32.maybe_refit()
    rank32 = m32._rank_pool

    def ranking32(state, cands, best_y):
        caps[0] = (state, cands, best_y, m32._snap)
        return rank32(state, cands, best_y)
    m32._rank_pool = ranking32
    m32.propose_pool(rng.key(SEED + 35, dev), t2.best.u, t2.best.perms,
                     t2._best_q)
    k = sm2.propose_batch
    cases, timed = [], {}
    for version, (state, cands, best_y, snap) in sorted(caps.items()):
        feats = sm2._sx(sm2.space.features(cands))
        blocks, kinv, params = acq.prep(state, feats, "ei", best_y, BETA,
                                        sm2._n_cont, sm2._n_cat)
        vg, ig = acq.topk_cuda(*blocks, kinv, params, "ei", k)
        vw, iw = acq.topk_plain(*blocks, kinv, params, "ei", k)
        ys = float(state.y_std)
        n = int(state.x.shape[0])
        # the same utilities in float64 from the same float32 operands
        b64 = [None if x is None else x.double() for x in blocks]
        ref = acq.utilities(*ps.tile_moments(
            ps.kernel_tile(*b64[:4]), b64[4], kinv.double()),
            params.double(), "ei")
        case = {"version": version or "16-row fit", "n": n,
                "in_bucket": snap.in_bucket,
                "exact": snap.exact, "extended": version in grown,
                "noise": float(state.noise),
                "index_mismatches": topk_index_mismatches(
                    iw, vw / ys, ig, SD_TOL),
                "values_err_over_tol": tol_excess(vg, vw, SD_TOL, ys)[1],
                "kernel_f64_err_over_tol": tol_excess(
                    vg, ref[ig.long()], SD_TOL, ys)[1],
                "plain_f64_err_over_tol": tol_excess(
                    vw, ref[iw.long()], SD_TOL, ys)[1],
                "descending": bool((vg[1:] <= vg[:-1]).all())}
        # D's picks a top k of the float64 utilities, but for rows within
        # twice the larger of the two versions' distance from float64
        slack = 2 * max(float((vg.double() - ref[ig.long()]).abs().max()),
                        float((vw.double() - ref[iw.long()]).abs().max()))
        case["picks_f64_ok"] = bool(
            ref[ig.long()].min() >= torch.sort(ref, descending=True)
            .values[k - 1] - slack)
        # the nominal rule; else D's picks within the tolerance of float64
        # or within TF32_ERROR_RATIO times the plain version's picks'
        # distance from it: at an ill-conditioned K^-1 (noise 1e-4 or
        # 1e-3 on clustered rows) both sit several tolerances away (the
        # plain version's farthest row of the pool is printed beside)
        case["plain_pool_f64_err_over_tol"] = tol_excess(
            acq.utilities_plain(*blocks, kinv, params, "ei"), ref, SD_TOL,
            ys)[1]
        case["ok"] = case["descending"] and (
            (not case["index_mismatches"]
             and case["values_err_over_tol"] <= 1)
            or (case["picks_f64_ok"] and case["kernel_f64_err_over_tol"]
                <= max(1.0, TF32_ERROR_RATIO
                       * case["plain_f64_err_over_tol"])))
        cases.append(case)
        if not case["ok"]:
            bad.append(f"D at the manager's shapes: {case}")
        if n not in timed:
            b, f = feats.shape
            timed[n] = dict(
                gp_bound(b, n, f, True, 8 * k + 20),
                shape=f"B={b} N={n} F={f} kind=ei k={k}",
                ms=median_ms(lambda: acq.topk_cuda(*blocks, kinv, params,
                                                   "ei", k)),
                plain_ms=median_ms(lambda: acq.topk_plain(
                    *blocks, kinv, params, "ei", k)),
                library_ms=median_ms(lambda: acq.select_topk(
                    acq.utilities_ref(*blocks, kinv, params, "ei"), k)))
    big["topk_cases"] = len(cases)
    big["topk_buckets"] = sorted(timed)
    big["topk_extended_cases"] = sum(c["extended"] for c in cases)
    big["topk_max_values_err_over_tol"] = max(
        (c["values_err_over_tol"] for c in cases), default=None)
    big["topk_nominal_ok_cases"] = sum(
        not c["index_mismatches"] and c["values_err_over_tol"] <= 1
        for c in cases)
    big["topk_max_kernel_f64_err_over_tol"] = max(
        (c["kernel_f64_err_over_tol"] for c in cases), default=None)
    big["topk_max_plain_f64_err_over_tol"] = max(
        (c["plain_f64_err_over_tol"] for c in cases), default=None)
    big["topk_max_plain_pool_f64_err_over_tol"] = max(
        (c["plain_pool_f64_err_over_tol"] for c in cases), default=None)
    big["topk_case_list"] = cases
    big["topk_index_mismatches"] = sum(c["index_mismatches"] for c in cases)
    big["topk_timed"] = timed
    if not big["topk_extended_cases"] or 32 not in timed or len(timed) < 2:
        bad.append(f"D checked at buckets {sorted(timed)}, "
                   f"{big['topk_extended_cases']} extended states")
    t2.close()
    out["large_pool"] = big

    # 3. the MLP ensemble; one fit on the card and on the CPU from the
    # same rows and init draws
    t3, stats3, commits3 = surrogate_tuner(dev, "mlp", CALIBRATED_OPTS,
                                           SEED + 32)
    mr = surrogate_run(t3, stats3, commits3, SD_MLP_LIMIT, bad)
    if mr["launches"] != kernels_want(commits3[0]):
        bad.append(f"mlp launches {mr['launches']}")
    sm3 = t3.surrogate
    x = np.stack(sm3._xs[:64])
    y = np.asarray(sm3._ys[:64], np.float32)
    init = mlp.draw_init(rng.Stream(rng.key(SEED + 34, dev)),
                         mlp.layer_sizes(x.shape[1]), sm3.n_members)
    fits = {d: mlp.fit(tuple(z.to(d) for z in init),
                       torch.from_numpy(x).to(d), torch.from_numpy(y).to(d),
                       n_members=sm3.n_members) for d in (dev, cpu)}
    xq3 = torch.from_numpy(np.stack(sm3._xs[:512]))
    pg = mlp.predict_members(fits[dev], xq3.to(dev)).cpu()
    pc = mlp.predict_members(fits[cpu], xq3)
    mr["fit_card_vs_cpu_over_y_std"] = float(
        (pg - pc).abs().max() / fits[cpu].y_std)
    if not mr["fit_card_vs_cpu_over_y_std"] <= MLP_TOL_Y_STD:
        bad.append(f"mlp fit on the card against the CPU: "
                   f"{mr['fit_card_vs_cpu_over_y_std']}")
    t3.close()
    out["mlp"] = mr

    # 4. one refit on the card and on the CPU from the same rows (the CPU
    # tune's) and keys
    snaps = {}
    for d in (dev, cpu):
        m = man.SurrogateManager(t.space, "gp", device=d, **CALIBRATED_OPTS)
        ks, kf = rng.split(rng.key(SEED + 33, d), 2).unbind(0)
        m._refit_full(rows_x, rows_y, ks, kf)
        snaps[d] = m._snap
    g, c = snaps[dev], snaps[cpu]
    refit = {"rows": len(rows_y), "bucket": int(g.state.x.shape[0]),
             "threshold_equal": g.threshold == c.threshold,
             "best_y_equal": g.best_y == c.best_y,
             "train_rows_equal": bool(torch.equal(g.state.x.cpu(),
                                                   c.state.x)),
             "noise": float(c.state.noise),
             "lengthscale": float(c.state.lengthscale)}
    refit.update(posterior_excess(g.state, c.state, xq_refit, nc, ncat))
    # each side's distance from the same fit in float64 (the CPU's
    # subsample, hyperparameters and standardisation)
    seed_word = int(rng.split(rng.key(SEED + 33, cpu), 2)[0, -1])
    _, ys_sub = man.SurrogateManager._host_subsample(
        rows_x, rows_y, seed_word, CALIBRATED_OPTS["max_points"])
    y_pad = torch.zeros(refit["bucket"])
    y_pad[:len(ys_sub)] = torch.from_numpy(ys_sub)
    f64 = gp_f64(c.state, y_pad, nc, ncat)
    for side, st in (("card", g.state), ("cpu", c.state)):
        e = posterior_excess(st, f64, xq_refit, nc, ncat)
        refit[f"{side}_f64_mean_err_over_tol"] = e["mean_err_over_tol"]
        refit[f"{side}_f64_sd_err_over_tol"] = e["sd_err_over_tol"]
    nominal = (refit["mean_err_over_tol"] <= 1
               and refit["sd_err_over_tol"] <= 1)
    near = all(refit[f"card_f64_{m}_err_over_tol"] <= max(
        1.0, 2 * refit[f"cpu_f64_{m}_err_over_tol"]) for m in ("mean", "sd"))
    refit["nominal_ok"], refit["f64_ok"] = nominal, near
    if not (refit["threshold_equal"] and refit["best_y_equal"]
            and refit["train_rows_equal"] and refit["hyperparameters_equal"]
            and (nominal or near)):
        bad.append(f"a refit on the card against the CPU: {refit}")
    out["refit_card_vs_cpu"] = refit
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    work.cleanup()
    if bad:
        raise AssertionError("surrogate driver: " + "; ".join(bad))
    return out, t


# the short name of every kernel function of csrc/*.cu (with its template
# arguments) within ptxas's mangled one
PTXAS_KERNEL = re.compile(
    r"(merge_rows_kernelILi\d+E|launch_floor_kernel|kinv_prep_kernel|"
    r"wq_kernel|moments_kernel|topk_merge_kernel|final_kernelILb\dE|"
    r"krows_kernelILb\dELb\dELb\dE|gp_mean_kernelILb\dELb\dE)")


def ptxas_summary(log: str) -> list:
    """One line per kernel function of a library: ptxas's registers,
    spills and shared memory."""
    out, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            short = PTXAS_KERNEL.search(m.group(1))
            fn = short.group(1) if short else m.group(1)
        elif fn and ("registers" in ln or "spill" in ln):
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return out


def profile_phase(step, st, ms_per_step: float, steps: int = 5,
                  name: str = "engine") -> None:
    """Device time by kernel over a short window of engine steps
    (`step(state) -> state`), and the device's idle share of an
    unprofiled step (`ms_per_step`, timed in the path's phase): the
    profiler's own host cost would inflate the window's wall time; and
    the host syncs of one more step, by line (`sync_count`)."""
    from torch.autograd import DeviceType

    def run():
        s = st
        for _ in range(steps):
            s = step(s)
    prof = profiled(run)
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and SENTINEL_KERNEL not in e.key), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    emit({"phase": "profile", "path": name, "steps": steps,
          "device_ms_per_step": busy_ms,
          "device_ops_per_step": sum(r[2] for r in rows) / steps,
          "ms_per_step_unprofiled": ms_per_step,
          "device_idle_share": 1 - busy_ms / ms_per_step,
          "syncs_per_step": sync_count(lambda: step(st)),
          "top": [{"name": k[:90], "device_us_per_step": us / steps,
                   "count_per_step": n / steps}
                  for us, k, n in rows[:20]]})


def passes_profile(cases, calls: int = 10) -> None:
    """Device time by kernel of A's kernel and of B's, C's and D's passes
    at the main state: a torch.profiler window over `calls` calls of each
    launcher."""
    from torch.autograd import DeviceType
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import pallas_score as ps
    st, xq, best, nc, ncat = cases["mixed_n1024"]
    blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
    runs = {"gp_mean": lambda: ps.mean_tile_cuda(*blocks),
            "gp_mean_var": lambda: ps.mean_var_tile_cuda(*blocks, kinv),
            "acquire_scores": lambda: acq.scores_cuda(*blocks, kinv, params,
                                                      "ei"),
            "acquire_topk": lambda: acq.topk_cuda(*blocks, kinv, params, "ei",
                                                  TOP_K)}
    for name, fn in runs.items():
        fn()
        prof = profiled(lambda: [fn() for _ in range(calls)])
        rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and SENTINEL_KERNEL not in e.key), reverse=True)
        emit({"phase": "profile", "path": f"{name}_passes", "calls": calls,
              "device_us_per_call": sum(r[0] for r in rows) / calls,
              "passes": [{"name": k[:90], "device_us_per_call": us / calls,
                          "count_per_call": c / calls}
                         for us, k, c in rows]})


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from uptune_tpu_torch import native
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = native.build()
    kernels = native.KERNELS
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(p.relative_to(ROOT)) for k, p in libs.items()},
          "ptxas": {str(k.library_path().relative_to(ROOT)): ptxas_summary(
              k.build_log) for k in kernels}})

    merge, timed, timed_driver = merge_phase(dev, args.profile)
    cases, feats = surrogate_phase(dev)
    _, gp_times = gp_kernels_phase(cases)
    eng, st, engine = engine_phase(dev)
    reference_phase(eng, st, dev)
    surr, st_s, ev, ev_mean, ev_ei = surrogate_engine_phase(eng, cases,
                                                            feats, dev)
    multi, (be_m, st_m) = batched_phase(dev)
    flag, (be_f, st_f, ev_f) = batched_flagship_phase(cases, feats, dev)
    tf32_phase(cases, feats, dev)
    pflag, (eng_pf, st_pf, ev_pf) = portfolio_flagship_phase(cases, feats,
                                                             dev)
    pbat, (be_pb, st_pb) = portfolio_batched_phase(dev)
    drv, tuner = driver_phase(dev)
    sdrv, stuner = surrogate_driver_phase(dev)
    if args.profile:
        profile_phase(eng.step, st, engine["ms_per_step"])
        profile_phase(lambda s: eng.step(s, eval_fn=ev), st_s,
                      surr["fused_ms_per_step"], name="surrogate_engine")
        profile_phase(lambda s: eng.step(s, eval_fn=ev_mean), st_s,
                      surr["score_flat_ms_per_step"],
                      name="score_flat_mean_engine")
        profile_phase(lambda s: eng.step(s, eval_fn=ev_ei), st_s,
                      surr["score_flat_ms_per_step"],
                      name="score_flat_ei_engine")
        profile_phase(lambda s: be_m.run(s, 1), st_m,
                      multi["runs"][0]["ms_per_step"],
                      name=f"batched_n{MULTI_N}")
        profile_phase(lambda s: be_f.run(s, 1, eval_fn=ev_f), st_f,
                      flag["ms_per_step"], name=f"batched_flagship_n{BF_N}")
        profile_phase(eng_pf.step, st_pf, pflag["plain_ms_per_step"],
                      name="portfolio_flagship")
        profile_phase(lambda s: eng_pf.step(s, eval_fn=ev_pf), st_pf,
                      pflag["scored_ms_per_step"],
                      name="portfolio_flagship_scored")
        profile_phase(lambda s: be_pb.run(s, 1), st_pb, pbat["ms_per_step"],
                      name=f"portfolio_batched_n{PB_N}")
        profile_phase(lambda s: (tuner.step(), s)[1], None,
                      drv["ms_per_ticket"], name="driver_ticket")
        profile_phase(lambda s: (stuner.step(), s)[1], None,
                      sdrv["calibrated"]["ms_per_ticket"],
                      name="surrogate_driver_ticket")
        passes_profile(cases)

    entries = []
    for k in kernels:
        common = {"name": k.name, "route": "cuda",
                  "source": str(k.source.relative_to(ROOT)),
                  "replaces": ", ".join(k.replaces), "matched": True}
        batched = {"launches_batched": multi["runs"][0]["launches"][k.name],
                   "launches_batched_flagship": flag["launches"][k.name],
                   "launches_portfolio_flagship": pflag["launches"][k.name],
                   "launches_portfolio_batched": pbat["launches"][k.name],
                   "launches_driver": drv["launches"][k.name],
                   "launches_surrogate_driver": sum(
                       sdrv[r]["launches"][k.name] for r in (
                           "calibrated", "large_pool", "mlp"))}
        if k.name == "merge_rows":
            entries.append(dict(
                common, **batched, launches=engine["launches"][k.name],
                max_abs_err=max(c["max_abs_err"] for c in merge["cases"]
                                + merge["instance_axis"]),
                instance_axis=[{key: c[key] for key in (
                    "shape", "ms", "call_ms", "launch_floor_ms",
                    "single_launches_ms", "single_calls_ms", "plain_ms",
                    "bound_ms")} for c in merge["instance_axis"]],
                shape=f"cap={timed['cap']} b={timed['b']}",
                ms=timed["ms"], kernel_ms=timed["ms"],
                call_ms=timed["call_ms"], plain_ms=timed["plain_ms"],
                bound_ms=timed["bound_ms"], bound_by="bytes",
                launch_floor_ms=timed["launch_floor_ms"],
                rows_per_block=timed["rows_per_block"],
                library_ms=timed["library_ms"],
                driver_shape={key: timed_driver[key] for key in (
                    "cap", "b", "ms", "call_ms", "launch_floor_ms",
                    "plain_ms", "library_ms", "bytes", "bound_ms")}))
            continue
        t = gp_times[k.name]
        entries.append(dict(
            common, **batched, launches=surr["launches"][k.name],
            max_abs_err=t["max_abs_err"],
            max_err_over_tol=t["max_err_over_tol"], shape=t["shape"],
            ms=t["ms"],
            kernel_ms=t["ms"], call_ms=t["call_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            **{key: t[key] for key in ("bound_f32_ms",) if key in t},
            **({"manager_shapes": {str(n): {key: v[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")} for n, v in sdrv["large_pool"][
                    "topk_timed"].items()}}
               if k.name == "acquire_topk" else {})))
    emit({"kernels": entries})
    torch.cuda.synchronize()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
