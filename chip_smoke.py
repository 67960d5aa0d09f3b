#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`uptune_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py              # the full check (one card)
    python3 chip_smoke.py --profile    # also a torch.profiler window
    python3 chip_smoke.py --gp-times --tree DIR
                                       # A-D's times and passes at F 31
                                       # and F 1028 from the checkout
                                       # DIR (the A/B mode)
    python3 chip_smoke.py --phases gp_wide,obs
                                       # these phases (and those whose
                                       # results they take) alone, for
                                       # an A/B call; no ok line
    python3 chip_smoke.py --phases store,parallel
                                       # the cooperative store and the
                                       # mesh plane alone
    python3 chip_smoke.py --phases notears,quickest
                                       # the tooling plane alone

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
             full), cap 2048 / b 2048, the serve phase's one-slot commit
             (cap 256 / b 102, half-full and full), and at the edges: b = 70,000 into cap 2^15 (most rows
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
             its grid and N single launches; then `rng`: the draws'
             kernel (csrc/rng.cu) bitwise against rng.py's torch ops at
             the main paths' block sizes (a key split's 4 words, the
             flagship's observe block of 182 and proposal block of
             515,158, gcc-options' observe block of 107,912 and proposal
             block of 8,616,696), for one key and a stacked [4, 2] key
             (its counter crossing 2^32), in both modes (a stream's
             24-bit words and uniforms; a split's whole words), and
             under vmap (one launch); `mismatches` must be 0; its
             launch and element counters; its time against the bytes
             it writes (12 an element drawn, 8 split) at 3.35 TB/s,
             beside an eager call's and the torch ops' times; then
             `features`: the GP's query features in one kernel
             (csrc/features.cu) bitwise against the torch chain it
             replaces, at gcc-options' C and D calls (B 6352, D 328, F
             1027) and the flagship's (B 6040, a 12-city tour, F 31);
             `mismatches` must be 0, and its launches and rows are
             counted through `native.counts()`; its time against the
             bytes it moves at 3.35 TB/s, beside an eager call's and the
             chain's times, and the device ops of one call of each; then
             `simplex`: NelderMead's proposal in one kernel
             (csrc/simplex.cu) bitwise against the torch chain it
             replaces, on the card and on the CPU, in INIT and LOOP, at
             the flagship's D 13, gcc-options' D 328 and four vmapped
             D 328 instances (one launch); `mismatches` must be 0 and
             its launches are counted through `native.counts()`; its
             time in LOOP against the bytes it moves at 3.35 TB/s,
             beside an eager call's and the chain's times, and the
             device ops of one call of each;
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
             then `gp_wide`: A-D at the gcc-options space's width (96
             continuous lanes + 233 categorical one-hot over 4 codes,
             F = 1028, from configurations of a space shaped like the
             mined one, `workloads.gcc_like_records`; past the 361
             features where krows leaves the CUDA cores for the tensor
             cores, and the 376 where A streams its query planes), a GP
             fitted on 1024 of them, at the main shapes (B 6040, N 1024,
             k 128), at its near-training case (the training rows, each
             continuous lane moved by +-0.01) and at the manager's (B
             4096, N 32-256, k 32), and a continuous-only and a
             categorical-only state of 400 lanes at the main shapes (the
             single-kind instances); krows' route as the library plans
             it at F 31, 361, 362, 400 and 1028; with the
             same rules (the nominal tolerance, or within the tolerance
             of float64 or 4x the plain version's distance from it where
             K^-1 is ill-conditioned); kernel, plain and library times
             and the bound there;
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
             refit, 20 `propose_topk(..., 128)`, then 10 steps each with
             impl="score_flat" for kind "mean" and "ei"; counts set to 0
             just before and read just after (C 50, D 20, A 10, B 10,
             merge 70, features 90: one a C or D call and a score_flat
             step); a finite best, valid tours, and the last epoch's
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
             scored by launcher C on the flat batch (C 20, merge 20,
             features 20 launches); C's scores of a flat batch against the CPU's
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
             70, C 20, features 20), a finite best, every stored tour a permutation,
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
             (500 evaluations; one fit on the card against the CPU's);
             and one GP refit on the card against the CPU's;
15a. topk_batched - launcher D over an instance axis (N segments of B
             rows against one GP in one launch, each with its own top
             k): the batched flagship's N 4 x 6040 rows at k 128 and the
             manager's pool N 64 x 4096 at k 32, each segment bitwise
             against its own single launch and within D's tolerances
             against `topk_plain`, timed against N single launches, the
             plain version and the library staging (two rounds in
             turns); then `BatchedEngine.propose_topk` on the flagship at
             N 4, 20 epochs with the counts reset (one D launch and one
             features launch an epoch, each instance's top k bitwise its
             own launch's,
             `global_topk`'s rows equal and its best the pool's);
15b. serve - the serving plane: the JAX package's serving protocol
             (`bench.py --serve`) against the port's SessionServer on
             the card: rosenbrock-4d over [-3, 3], the default arms (102
             rows an epoch), 1024 tenants in one 1024-slot group, 3
             epoch waves, the memo store on, 8 closes and 8 opens of
             churn between epochs, T = min(16, 2 cpus, 1024 / 8) client
             threads over localhost TCP, a probe session's epoch alone
             first; aggregate asks/s, ask p50 / p95, time to the first
             trial, proposes, commits, batch fill, the stacked state's
             bytes, and the merge's launches (equal to the commits: one
             a committed tenant epoch); where the waves' wall goes (the
             server's commit and propose spans, each group's lock timed,
             the process's CPU seconds over the wall); 8 sampled
             tenants' offered configs bitwise equal to LocalSessions at
             matched seeds on the card; the same drive with the groups on the CPU at 128
             tenants (cut from 1024 for the time limit); then
             `python -m uptune_tpu_torch.cli serve --port 0` as a
             process: one ask / tell over TCP, SIGTERM, exit code 0;
15c. route - the sharded front tier: a port `Router` (serve/router.py)
             over K `python -m uptune_tpu_torch.cli serve --durable
             --device cuda` shard processes on the card, each its own
             CUDA context.  (a) The JAX package's sharded protocol
             (`bench.py --serve-sharded`, not --quick): rosenbrock-2d
             over six space signatures walked until s0..s2 all own
             sessions and s0 some but not all, one session a signature,
             chunk 8; K walked 1 -> 2 -> 3 by the scale op, 4 epochs a
             round (asks/s and the scale op's seconds a K), the shards
             traced (UT_DEVICE_TRACE, one directory a shard); then a
             short round at K 3 held after its first epoch while the
             router's metrics and sources ops and `python -m
             uptune_tpu_torch.cli top --addr <router> --once --fleet
             --json` are read (3 sources); `Router.stop()` ends the
             shards with SIGTERM (final windows shipped): in each shard's
             trace the merge kernel's launches equal its serve.commits
             (its final window in the router's fleet timeline) and no
             other kernel of the port appears; then
             a fresh tier of 3, untraced, 6 epochs of auto-resume clients
             while `route.kill` SIGKILLs s0 once on a supervisor tick
             (kills 1, s0 restarted once, no other restart), zero acked
             committed loss, versions that never go back, every session
             finished and equal (best config bit for bit, qor, version)
             to a matched-seed LocalSession on the card; (b) the serve
             phase's protocol routed: rosenbrock-4d, 16 signatures of 64
             tenants (1024) over 3 shards of 64-slot groups, one thread a
             signature, the memo on, a probe epoch alone, then
             ROUTE_WAVES epoch waves: Router.start() (serial cold
             starts, from the router's shards op) and the first trial
             after it, asks/s, client ask p50 / p95, each shard's commits
             and proposes (its own scrape and its final window in the
             fleet timeline), the fleet serve.commits of a hub replaying
             that timeline equal to their sum, every tenant's epoch
             committed, the shards' and the load generator's CPU seconds
             over the wall, and routed asks/s over the serve phase's;
15d. store - the cooperative store: the JAX package's store protocol
             (`bench.py --store-remote`, not --quick) on the port: one
             `python -m uptune_tpu_torch.cli store` server process, K 3
             cooperating child processes (`chip_smoke.py --store-child`,
             each on the card in its own CUDA context: a journaled
             `Tuner(surrogate="gp")` with a synchronous refit over
             rosenbrock-4d on the int grid [-6, 6], budget 300, target
             3.0, a `RemoteStore` refreshed every 0.02 s, the store hit /
             record / exchange / federate loop of the controller), then
             3 independent matched-seed children, each set at once; evals
             to the target coop against independent (printed, not
             gated), exchanges and federated rows, each child's cold
             start, commits, merge launches (its wrapper's count, its
             commits; in the cooperating fleet also its own
             UT_DEVICE_TRACE=DIR/<tag>'s kernels: its commits, no other
             kernel of the port; the independent fleet goes untraced for
             the time limit), and each child's online quality
             gauges equal to an offline replay of its journal; then the
             kill: a server armed with `rstore.append=crash@25` under 3
             writing `RemoteStore`s dies with rc 137, every acked row is
             served by a server restarted on the same directory, a
             record while it is down takes under 100 ms, and the
             surviving client drains its backlog;
15e. parallel - the mesh plane at the main path's width (the flagship
             at scale 64, a 2^15-row history; the GP at N 1024, F 31,
             EI): (a) `ShardedEngine` over local meshes of the card, 50
             steps: (search 1, eval 4) bitwise equal to `FusedEngine.run`
             from the replica's key, (search 2, eval 2) every replica
             holding the global best; merge once a replica a commit, and
             ms/step; (b) `BatchedEngine(flagship, N 4,
             mesh=make_instance_mesh(2))` scored by C (C, the features
             and the merge once a shard a step), against the unsharded route: the run
             bitwise where C's scores do not depend on a launch's rows,
             and `global_topk` at k 128 (D and the features once a
             shard, then the gather): owners and indices bitwise, values bitwise or
             within the sd tolerance; (c) `sharded_gp_score` over 2 x
             6040 rows (B once a shard) against one launch of B over
             12,080 rows and against the plain version, B's time a shard
             and the gather's; (d) two ranks on the one card
             (`chip_smoke.py --mesh-rank` started with `ut-torch
             --num-hosts`'s UT_* environment, gloo, the card's tensors
             staged through pinned host memory) running `ShardedEngine`
             (search 2, eval 1): both ranks' global best equal to each
             other and to a one-process local mesh bitwise, with
             `init_process_group`'s seconds; then the same steps in a
             one-rank NCCL group;
16. program - program mode: `python -m uptune_tpu_torch.cli
             rosenbrock.py -pf 4 --test-limit 100 --seed 0` on a copy of
             the unchanged sample (its child imports the JAX package):
             exit 0, a finite best no worse than the default, 100 told
             trials of distinct configurations, best.json equal to the
             printed line; `--resume --test-limit 125` builds no archived
             configuration again; the same tune with `--device cpu` (the
             three CLI runs cut from 200 and 250 trials for the time
             limit); the ProgramTuner in process at -pf 4, 100 trials
             (counts set to 0 just
             before and read just after: one merge launch a committing
             ticket, nothing else; host syncs a ticket by line; median
             t_propose / t_dedup against t_eval_wait; pool utilisation);
             two runs at one worker without prefetch, the child
             importing either package, with equal archives (and the
             child's import time, without torch), the port child's run
             traced with the tuning journal on (the trace valid, the
             journal's step rows numbering the tickets, the children's
             sidecar spans on the worker lane); then the gcc-options
             sample (the machine's g++ mined first, timed) through the
             CLI's main with `--learning-models gp -pf 4 --test-limit
             24 --runtime-limit 120`: a finite best beside the default
             -O2's, the width, builds, refits, no launch of D (a
             512-row pool) and the merge's launches; then the C++ header
             client's demo (cpp/demo, built with g++) tuned by the
             ProgramTuner for 30 trials at -pf 2: its four parameters
             discovered, the default cost 7.4, a best no worse, the
             merge launched, and the best applied back through the
             client's BEST mode;
17. obs    - the observability plane on the card: the program phase's
             traced run; ms a ticket of the driver phase's Tuner with
             obs off and with trace + journal on, in turns (the ratio
             beside the JAX package's 0.95x bar); one `record_window`
             of the surrogate-scored flagship step (through the
             instrumented engine.run, C's counted work) against the
             H100 peaks of `obs.device.PEAKS`; and the size of a
             `--device-trace` capture of three such steps, which must
             hold CUDA kernels and the host spans' ranges;
    notears - NOTEARS on the card (`plugins/notears.py`, eager
             projected-Adam steps through `torch.linalg.matrix_exp`):
             test_notears.py's medium graphs (d 10, 12 edges, n 1500,
             seeds 1-3, drawn on the CPU by the port's `simulate_dag`):
             median F1 at least 0.8, each support that of the port's
             CPU run of the same data, and its refit weights bitwise
             where the structure the refit ran on is the CPU's (within
             0.25, the reference's magnitude bar, where a
             near-threshold entry fell the other way; reported); its
             covariate-graph construction (n 600: a drives the QoR, c
             does not); a d 32 graph (48 edges, n 4000; F1 and the CPU
             comparison printed); seconds,
             subproblems and Adam steps a second, card and CPU (each
             card run a process of its own, the five at once beside one
             process of the CPU runs: `--notears-run DEVICE NAME...`);
             no kernel of the port launched;
    quickest - QuickEst on the card: `train` on 2000 rows of 256
             features (a few drive each target, the rest noise) and four
             targets with the default options into a model directory
             (the lasso's and the MLP's seconds a target), `test` on 500
             held-out rows (LUT_impl's R2 above 0.85), the directory
             loaded on the CPU (the same `sel`, predictions within 1e-5
             of each target's std) and LUT_impl's lasso again on the CPU
             (the same `sel`, w within 1e-5 of its largest entry);
    stats  - `python -m uptune_tpu_torch.utils.stats` (`ut-torch-stats`)
             over the program phase's CLI archive: the report's
             evaluations sum to the archive's rows, and `--csv` writes
             one row for each trial that improved its technique's best;
18. profile (with --profile) - device time by kernel, the idle share and
             the host synchronisations over a few plain, surrogate-scored
             (by launcher C, then by `score_flat` through A and through B),
             batched (N = 256 and the N = 4 flagship) and portfolio
             (plain and scored flagship, batched N = 256) engine steps
             and driver tickets (plain, and with the calibrated GP
             manager), and the device time of A's kernel and of each
             pass of B, C and D at F 31 and at F 1028;
19. kernels - one entry per kernel (the draws' kernel's from the rng
             phase and the engine's steps): launches on the main path, error
             against the plain version (and, for the GP kernels, its
             largest ratio to the tolerance), times and bound; the merge
             also over its instance axis and at the driver's shape, and
             the launches of the batched, portfolio, driver, surrogate
             driver, program, propose_topk, serve, route, store and
             parallel paths (the route path's from the traced shards'
             device traces; D also timed
             at the manager's shapes and over its instance axis), and
             A-D's times at F = 1028.

"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import threading
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
    # the serve phase's one-slot commit: the default arms' 102 rows into
    # a tenant's 256-row history, before and after it fills (eviction)
    ("cap256_b102_half", 256, 102, 128),
    ("cap256_b102_full", 256, 102, 256),
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
# (the calibrated runs' 2000 cut to 1000 for the time limit when the route
# phase came in, the MLP run's 1000 to 500 when the tooling plane did)
SD_LIMIT, SD_POOL_LIMIT, SD_MLP_LIMIT = 1000, 1000, 500
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
# the widest space the repo ships: samples/gcc-options over g++ 12 (232
# flags, 95 params, olevel, block_size) is 96 continuous lanes and 233
# categorical ones one-hot over 4 codes, F = 1028, past the 361 / 376
# features one block of krows / A held before they took chunks; checked at
# the main shapes and at the manager's (B 4096, its buckets N, k 32)
WIDE_N_TRAIN, WIDE_MANAGER_B, WIDE_MANAGER_K = 1024, 4096, 32
WIDE_MANAGER_N = (32, 64, 128, 256)
# lanes of the continuous-only and the categorical-only wide states (400
# floats; 100 enums one-hot over 4 codes), past both limits too
WIDE_SINGLE = 400
# widths at which gp_wide reads krows' route from the library: either side
# of the 361 features one CUDA-core block holds, and the wide states'
KROWS_ROUTE_WIDTHS = (31, 361, 362, WIDE_SINGLE, 1028)
WIDE_KEYS = ("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "max_err_over_tol")
# program mode: the rosenbrock sample's trials through the CLI and in
# process, the trials of its resume, of the lockstep runs, and of the
# gcc-options tune (builds of ~3 s each); the in-process run cut from 200
# to 100 trials for the time limit when the tooling plane came in
PROGRAM_LIMIT, PROGRAM_LOCKSTEP, GCC_LIMIT = 100, 60, 24
# the CLI runs (on the card, resumed, on the CPU), cut from 200 and 250
# trials for the time limit when the route phase came in
CLI_LIMIT, CLI_RESUME = 100, 125
# the obs phase: surrogate-scored flagship steps in its record_window
OBS_STEPS = 20
# D over an instance axis: (segments, rows a segment, k)
TOPK_SEGMENTS = ((BF_N, 6040, TOP_K), (64, 4096, 32))
TOPK_EPOCHS = 20
# the serving protocol: tenants on the card and on the CPU, epochs, and
# the closes (and opens) between epochs
# (the CPU's cut from 1024 to 256, then to 128, for the time limit)
SERVE_SESSIONS, SERVE_CPU_SESSIONS, SERVE_EPOCHS, SERVE_CHURN = (
    1024, 128, 3, 8)
# the sharded front tier (bench.py --serve-sharded, not --quick): six
# space signatures of rosenbrock-2d, one session each, chunk 8; K walked
# 1 -> 2 -> 3 by the scale op, 4 epochs a round (the scaling run, its
# shards traced), then 6 epochs across one route.kill of s0 on a fresh
# tier of 3; and the serve phase's protocol over 16 signatures of 64
# tenants on 3 shards, in ROUTE_WAVES epoch waves
ROUTE_SPACES, ROUTE_EPOCHS, ROUTE_CHUNK, ROUTE_K = 6, 4, 8, (1, 2, 3)
ROUTE_SIGS, ROUTE_TENANTS, ROUTE_SHARDS, ROUTE_WAVES = 16, 1024, 3, 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()


def kernel_launches() -> dict:
    """Launches of each hand-written kernel since the last reset, by
    name, but for the draws' kernel (rng_block) and the simplex's
    (simplex_propose): the first launches once a stream block or key
    split, the second once a NelderMead proposal, counts the phases
    below do not predict; the rng and simplex phases hold them, and the
    engine phase counts both a step.  The features kernel
    (surrogate_features) launches once a C or D call scored through
    `surrogate_eval_fn`."""
    from uptune_tpu_torch import native
    return {k.name: k.launches for k in native.KERNELS
            if k not in (native.RNG, native.SIMPLEX)}


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


# -- the draws' kernel against rng.py's torch ops ------------------------------
# the main paths' block sizes: a key split's 4 words, the flagship's
# observe and proposal blocks, gcc-options' observe and proposal blocks
RNG_COUNTS = (4, 182, 107_912, 515_158, 8_616_696)
RNG_STACK = 4                   # rows of the stacked key


def rng_kernel(key, mode: str, start: int, count: int) -> tuple:
    """The custom op of `mode` on the card (the kernel): (words,) or
    (24-bit words, uniforms)."""
    from uptune_tpu_torch import rng
    if mode == "split":
        return (torch.ops.uptune_tpu_torch.rng_hash(key, rng._SPLIT, start,
                                                    count),)
    return tuple(torch.ops.uptune_tpu_torch.rng_block(key, start, count))


def rng_plain(key, mode: str, start: int, count: int) -> tuple:
    """The same block from rng.py's torch ops, on the key's device."""
    from uptune_tpu_torch import rng
    if mode == "split":
        return (rng._hash_torch(key, rng._SPLIT, start, count),)
    return tuple(rng._block_torch(key, start, count))


def rng_mismatches(got: tuple, want: tuple) -> int:
    """Elements whose bits differ, over every output."""
    return sum(int((col_bits(g) != col_bits(w)).sum())
               for g, w in zip(got, want))


def rng_phase(dev) -> dict:
    """The draws' kernel bitwise against the torch ops, its counters, and
    its times at each block size (one key)."""
    from uptune_tpu_torch import native, rng
    one = rng.key(SEED + 21, dev)
    stacked = rng.split(one, RNG_STACK)
    out = {"phase": "rng", "tolerance": "bitwise", "cases": []}
    native.reset_launches()
    rows_drawn = 0
    for count in RNG_COUNTS:
        # the stacked key from a counter just below 2^32, so that it
        # crosses it
        for shape, key, start in (("[2]", one, 0),
                                  (f"[{RNG_STACK}, 2]", stacked,
                                   2**32 - count // 2)):
            for mode in ("draw", "split"):
                got = rng_kernel(key, mode, start, count)
                want = rng_plain(key, mode, start, count)
                torch.cuda.synchronize()
                out["cases"].append({
                    "count": count, "key": shape, "start": start,
                    "mode": mode,
                    "mismatches": rng_mismatches(got, want)})
                rows_drawn += (1 if key.dim() == 1 else RNG_STACK) * count
                del got, want
    vm = torch.func.vmap(lambda k: rng_kernel(k, "draw", 5, 182))(stacked)
    torch.cuda.synchronize()
    out["cases"].append({"count": 182, "key": f"vmap [{RNG_STACK}, 2]",
                         "start": 5, "mode": "draw",
                         "mismatches": rng_mismatches(
                             vm, rng_plain(stacked, "draw", 5, 182))})
    rows_drawn += RNG_STACK * 182
    want_counts = (4 * len(RNG_COUNTS) + 1, rows_drawn)
    out["launches"], out["elements"] = native.RNG.launches, \
        native.RNG.elements
    out["mismatches"] = sum(c["mismatches"] for c in out["cases"])
    fn = native.RNG.function()
    out["timed"] = {}
    for count in RNG_COUNTS:
        words = torch.empty(count, dtype=torch.int64, device=dev)
        floats = torch.empty(count, dtype=torch.float32, device=dev)
        for mode, f_ptr, per in (("draw", floats.data_ptr(), 12),
                                 ("split", None, 8)):
            domain = rng._DRAW if mode == "draw" else rng._SPLIT

            def kernel(f_ptr=f_ptr, domain=domain):
                native.check(fn(one.data_ptr(), words.data_ptr(), f_ptr, 1,
                                count, 0, domain,
                                torch.cuda.current_stream().cuda_stream),
                             native.RNG)
            bound = count * per / HBM_BYTES_PER_S * 1e3
            ms = median_ms(kernel)
            out["timed"].setdefault(str(count), {})[mode] = {
                "ms": ms, "bound_ms": bound, "roofline_pct": 100 * bound / ms,
                "bytes": count * per, "bound_by": "bytes",
                "call_ms": call_ms(lambda: rng_kernel(one, mode, 0, count)),
                "plain_ms": median_ms(lambda: rng_plain(one, mode, 0, count),
                                      reps=10 if count > 10**6 else REPS)}
        del words, floats
    emit(out)
    if out["mismatches"]:
        raise AssertionError(f"rng kernel: {out['mismatches']} elements "
                             f"differ from the torch ops")
    if (out["launches"], out["elements"]) != want_counts:
        raise AssertionError(f"rng kernel counted {out['launches']} "
                             f"launches and {out['elements']} elements, "
                             f"expected {want_counts}")
    return out


# -- the GP's query features in one kernel against the torch chain ------------
# (configuration, rows a C or D call scores): gcc-options' (D 328, F 1027)
# and the flagship's (D 13, one 12-city tour, F 31)
FEATURE_SHAPES = (("gcc-options-g12", 6352), ("flagship-s64", 6040))
FEATURE_CALLS = 3               # launches a shape's parity check counts


def feature_space(name: str):
    if name == "flagship-s64":
        from uptune_tpu_torch.flagship import flagship_space
        return flagship_space()
    from portbench.drivers.common import program_space
    cfg = ROOT / "portbench" / "configs" / f"{name}.json"
    return program_space(json.loads(cfg.read_text())["space"])


def features_phase(dev) -> dict:
    """The features kernel (csrc/features.cu) bitwise against the torch
    chain it replaces (`surrogate_transform(features(cands))`) at each
    shape of FEATURE_SHAPES; its launches and rows by `native.counts()`;
    its time against its bytes at 3.35 TB/s, beside an eager call's and
    the chain's; the device ops of one call of each (profiler) and the
    kernel's name as the profiler gives it."""
    from uptune_tpu_torch import native, rng
    from uptune_tpu_torch.space.spec import CandBatch
    out = {"phase": "features", "tolerance": "bitwise", "shapes": {}}
    for name, b in FEATURE_SHAPES:
        space = feature_space(name)
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        u = torch.rand(b, space.n_scalar, generator=gen, device=dev)
        cands = CandBatch(u, space.random(rng.generator(SEED + 32, dev),
                                          b).perms)

        def kernel():
            return space.surrogate_features(cands)

        def chain():
            return space.surrogate_transform(space.features(cands))
        want = chain()
        before = native.counts()
        mismatches = 0
        for _ in range(FEATURE_CALLS):
            got = kernel()
            torch.cuda.synchronize()
            mismatches += int((col_bits(got) != col_bits(want)).sum())
        counted = native.counts() - before
        d, p, f = space.n_scalar, sum(space.perm_sizes), got.shape[1]
        nbytes = b * (4 * d + 8 * p + 4 * f)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = median_ms(kernel)
        kernel_ops = device_events(profiled(kernel))
        chain_ops = device_events(profiled(chain))
        out["shapes"][name] = {
            "b": b, "d": d, "p": p, "f": f, "mismatches": mismatches,
            "launches": counted[native.FEATURES, "launches", None],
            "elements": counted[native.FEATURES, "elements", None],
            "other_counts": {f"{k.name}.{field}": n for (k, field, _), n
                             in counted.items() if k is not native.FEATURES},
            "ms": ms, "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
            "roofline_pct": 100 * bound / ms, "call_ms": call_ms(kernel),
            "plain_ms": median_ms(chain), "plain_call_ms": call_ms(chain),
            "device_ops": len(kernel_ops),
            "kernel_names": sorted({e.name for e in kernel_ops}),
            "plain_device_ops": len(chain_ops)}
        del got, want, cands, u
    emit(out)
    for name, c in out["shapes"].items():
        if c["mismatches"]:
            raise AssertionError(f"features kernel at {name}: "
                                 f"{c['mismatches']} elements differ from "
                                 f"the torch chain")
        if (c["launches"], c["elements"], c["other_counts"]) != (
                FEATURE_CALLS, FEATURE_CALLS * c["b"], {}):
            raise AssertionError(f"features kernel at {name}: counted "
                                 f"{c['launches']} launches, "
                                 f"{c['elements']} rows and "
                                 f"{c['other_counts']}, expected "
                                 f"{FEATURE_CALLS} launches alone")
        if c["device_ops"] != 1:
            raise AssertionError(f"features kernel at {name}: "
                                 f"{c['device_ops']} device ops a call")
    return out


# -- NelderMead's proposal in one kernel against the torch chain -------------
# (name, D, instances): the flagship's RandomNelderMead (D 13, S 14),
# gcc-options' (D 328, S 329) and gcc-options -pf 4's vmapped proposal
SIMPLEX_SHAPES = (("flagship", 13, 1), ("gcc-options", 328, 1),
                  ("gcc-options-pf4", 328, 4))
SIMPLEX_COEFFS = (2.0, 2.0, 0.5, 0.5)  # alpha, gamma, beta, sigma
SIMPLEX_CALLS = 3                      # launches a shape's parity check counts


def simplex_inputs(d: int, n: int, phase: int, dev) -> tuple:
    """n states of S = d + 1 points in `phase`: uniform simplexes, normal
    values with ties and +inf among them (LOOP), uniform padding rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 41 + d + phase)
    s = d + 1
    pts = torch.rand(n, s, d, generator=gen, device=dev)
    vals = torch.randn(n, s, generator=gen, device=dev)
    vals[:, ::7] = vals[:, :1]
    vals[:, 3::11] = float("inf")
    draws = torch.rand(n, 3, d, generator=gen, device=dev)
    phases = torch.full((n,), phase, dtype=torch.int32, device=dev)
    return pts, vals, draws, phases


def simplex_phase(dev) -> dict:
    """The simplex kernel (csrc/simplex.cu) bitwise against the torch
    chain it replaces (`ops/simplex.py::propose_chain`, on the card and
    on the CPU) at each shape of SIMPLEX_SHAPES, in INIT and in LOOP; its
    launches by `native.counts()`; its time in LOOP against its bytes at
    3.35 TB/s, beside an eager call's and the chain's; the device ops of
    one call of each (profiler)."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.ops import simplex as simplex_ops
    from uptune_tpu_torch.techniques.simplex import INIT, LOOP
    out = {"phase": "simplex", "tolerance": "bitwise", "shapes": {}}

    def batched(fn, n):
        def run(pts, vals, draws, phase):
            if n == 1:
                return tuple(o[None] for o in fn(pts[0], vals[0], draws[0],
                                                 phase[0], *SIMPLEX_COEFFS))
            return torch.func.vmap(lambda *a: fn(*a, *SIMPLEX_COEFFS))(
                pts, vals, draws, phase)
        return run
    for name, d, n in SIMPLEX_SHAPES:
        kernel_fn = batched(simplex_ops.simplex_propose, n)
        chain_fn = batched(simplex_ops.propose_chain, n)
        case = {"d": d, "s": d + 1, "n": n, "mismatches": {}}
        for phase in (INIT, LOOP):
            args = simplex_inputs(d, n, phase, dev)
            want = chain_fn(*args)
            want_cpu = chain_fn(*(a.cpu() for a in args))
            before = native.counts()
            bad_card = bad_cpu = 0
            for _ in range(SIMPLEX_CALLS):
                got = kernel_fn(*args)
                torch.cuda.synchronize()
                for g, w, c in zip(got, want, want_cpu):
                    bad_card += int((col_bits(g) != col_bits(w)).sum())
                    bad_cpu += int((col_bits(g).cpu()
                                    != col_bits(c)).sum())
            counted = native.counts() - before
            key = "init" if phase == INIT else "loop"
            case["mismatches"][key] = {"card_chain": bad_card,
                                       "cpu_chain": bad_cpu}
            case[f"{key}_launches"] = counted[native.SIMPLEX, "launches",
                                              None]
            case[f"{key}_other_counts"] = {
                f"{k.name}.{field}": v for (k, field, _), v
                in counted.items() if k is not native.SIMPLEX}
        s = d + 1
        nbytes = n * 4 * ((s * d + s) + ((2 * s + 3) * d + s))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        args = simplex_inputs(d, n, LOOP, dev)
        ms = median_ms(lambda: kernel_fn(*args))
        kernel_ops = device_events(profiled(lambda: kernel_fn(*args)))
        chain_ops = device_events(profiled(lambda: chain_fn(*args)))
        case.update({
            "ms": ms, "bytes": nbytes, "bound_ms": bound,
            "bound_by": "bytes", "roofline_pct": 100 * bound / ms,
            "call_ms": call_ms(lambda: kernel_fn(*args)),
            "plain_ms": median_ms(lambda: chain_fn(*args)),
            "plain_call_ms": call_ms(lambda: chain_fn(*args)),
            "device_ops": len(kernel_ops),
            "kernel_names": sorted({e.name for e in kernel_ops}),
            "plain_device_ops": len(chain_ops)})
        out["shapes"][name] = case
    emit(out)
    for name, c in out["shapes"].items():
        bad = {k: v for k, v in c["mismatches"].items() if any(v.values())}
        if bad:
            raise AssertionError(f"simplex kernel at {name}: elements "
                                 f"differ from the torch chain: {bad}")
        for key in ("init", "loop"):
            if (c[f"{key}_launches"], c[f"{key}_other_counts"]) != (
                    SIMPLEX_CALLS, {}):
                raise AssertionError(
                    f"simplex kernel at {name} ({key}): counted "
                    f"{c[key + '_launches']} launches and "
                    f"{c[key + '_other_counts']}, expected {SIMPLEX_CALLS} "
                    f"launches alone")
        if c["device_ops"] != 1:
            raise AssertionError(f"simplex kernel at {name}: "
                                 f"{c['device_ops']} device ops a call")
    return out


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
    rate, whichever is larger.  The distances' cross term and k K^-1 are
    matrix products the tensor cores can take in 3xTF32, which keeps
    f32's accuracy (A does the first there, B, C and D the second): for
    every launcher both count as 3x their FLOPs in TF32 at the dense TF32
    rate, the rest at the f32 rate; `bound_f32_ms` is the bound with
    every FLOP at the f32 rate, beside it."""
    mm = 2 * b * n * n if var else 0
    rest = 2 * b * n * f + 2 * b * n + (2 * b * n if var else 0)
    tc = 2 * b * n * f + mm
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

    bounds = launcher_bounds(b, n, f, shape)
    plain = plain_calls(blocks, kinv, params)
    timed = {name: (kern, *plain[name], *bounds[name])
             for name, kern in launcher_calls(blocks, kinv, params).items()}
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


def launcher_calls(blocks, kinv, params) -> dict:
    """A-D on one set of operands (kind EI, D's k = TOP_K), by kernel
    name: the calls every timing and profile of them makes."""
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import pallas_score as ps
    return {"gp_mean": lambda: ps.mean_tile_cuda(*blocks),
            "gp_mean_var": lambda: ps.mean_var_tile_cuda(*blocks, kinv),
            "acquire_scores": lambda: acq.scores_cuda(*blocks, kinv, params,
                                                      "ei"),
            "acquire_topk": lambda: acq.topk_cuda(*blocks, kinv, params,
                                                  "ei", TOP_K)}


def launcher_bounds(b: int, n: int, f: int, shape: str) -> dict:
    """A-D's bounds (`gp_bound`) and shape labels at B query rows, N
    training rows and F features, by kernel name: (bound, shape)."""
    return {"gp_mean": (gp_bound(b, n, f, False, 4 * b), shape),
            "gp_mean_var": (gp_bound(b, n, f, True, 8 * b), shape),
            "acquire_scores": (gp_bound(b, n, f, True, 4 * b + 20),
                               shape + " kind=ei"),
            "acquire_topk": (gp_bound(b, n, f, True, 8 * TOP_K + 20),
                             shape + f" kind=ei k={TOP_K}")}


def plain_calls(blocks, kinv, params) -> dict:
    """A-D's plain versions and library stagings on the same operands:
    {kernel name: (plain, library)}."""
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import pallas_score as ps
    return {
        "gp_mean": (lambda: ps.mean_tile_plain(*blocks),
                    lambda: ps.tile_moments(ps.kernel_tile(*blocks[:4]),
                                            blocks.alpha)[0]),
        "gp_mean_var": (lambda: ps.mean_var_tile_plain(*blocks, kinv),
                        lambda: ps.tile_moments(ps.kernel_tile(*blocks[:4]),
                                                blocks.alpha, kinv)),
        "acquire_scores": (
            lambda: acq.utilities_plain(*blocks, kinv, params, "ei"),
            lambda: acq.utilities_ref(*blocks, kinv, params, "ei")),
        "acquire_topk": (
            lambda: acq.topk_plain(*blocks, kinv, params, "ei", TOP_K),
            lambda: acq.select_topk(
                acq.utilities_ref(*blocks, kinv, params, "ei"), TOP_K))}


def gp_times_phase(dev) -> dict:
    """A-D's kernel times alone (CUDA events around graph replays, the
    median of REPS) at the main state (B 6040, N 1024, F 31, EI, k 128)
    and at gp_wide's (the same shapes at F 1028), with each launcher's
    passes profiled at both and, at F 1028, the plain and library times;
    and D's single list timed as a call at both.
    The A/B mode (`--gp-times --tree DIR`): run once for each tree in
    turns (parent, change, change, parent), one process each; it calls
    only entry points the parent trees have too."""
    from uptune_tpu_torch.flagship import flagship_surrogate
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import gp
    x, y, (nc, ncat) = flagship_surrogate(N_TRAIN, SEED + 1, dev)
    xq, _, _ = flagship_surrogate(6040, SEED + 2, dev)
    st = gp.precompute_kinv(gp.fit_auto_bucketed(
        x, y, max_points=N_TRAIN, n_cont=nc, n_cat=ncat))
    states = {"f31": (st, xq, float(y.min()), nc, ncat)}
    x, y, (nc, ncat) = wide_surrogate("gcc", WIDE_N_TRAIN, SEED + 41, dev)
    xq, _, _ = wide_surrogate("gcc", 6040, SEED + 42, dev)
    st = gp.precompute_kinv(gp.fit_auto_bucketed(
        x, y, max_points=WIDE_N_TRAIN, n_cont=nc, n_cat=ncat))
    states[f"f{x.shape[1]}"] = (st, xq, float(y.min()), nc, ncat)
    out = {"phase": "gp_times", "tree": str(Path(
        sys.modules["uptune_tpu_torch"].__file__).parent.parent)}
    for key, (st, xq, best, nc, ncat) in states.items():
        blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
        fns = launcher_calls(blocks, kinv, params)
        out[key] = {"shape": f"B={xq.shape[0]} N={st.x.shape[0]} "
                             f"F={xq.shape[1]} kind=ei k={TOP_K}",
                    "ms": {name: median_ms(fn) for name, fn in fns.items()},
                    # D's single list as the engine calls it (host launch
                    # included): the wrapper, and `topk_tile`, which goes
                    # through the custom op where a tree has one
                    "topk_call_ms": {
                        "topk_cuda": call_ms(fns["acquire_topk"]),
                        "topk_tile": call_ms(lambda: acq.topk_tile(
                            *blocks, kinv, params, "ei", TOP_K))}}
        if key != "f31":
            out[key]["plain_ms"], out[key]["library_ms"] = (
                {name: median_ms(c[i], reps=10)
                 for name, c in plain_calls(blocks, kinv, params).items()}
                for i in (0, 1))
        out[key]["passes"] = passes_profile(fns)
    emit(out)
    return out


# -- launchers A-D at the gcc space's width ------------------------------------

def wide_records(kind: str) -> list:
    """Param records of the gp_wide phase's spaces: "gcc", shaped like
    the gcc-options sample's (`workloads.gcc_like_records`: no g++
    mining), F 1028 in both blocks; "cont", WIDE_SINGLE float params (the
    continuous block alone); "cat", WIDE_SINGLE / 4 enums of 4 options
    (the categorical block alone)."""
    from uptune_tpu_torch.workloads import gcc_like_records
    if kind == "gcc":
        return gcc_like_records()
    if kind == "cont":
        return [{"name": f"p{i:03d}", "type": "float", "default": 0.5,
                 "lo": 0.0, "hi": 1.0} for i in range(WIDE_SINGLE)]
    return [{"name": f"e{i:03d}", "type": "enum", "default": "a",
             "options": ["a", "b", "c", "d"]}
            for i in range(WIDE_SINGLE // 4)]


def wide_surrogate(kind: str, n: int, seed: int, dev):
    """n configurations drawn from the space of `wide_records(kind)`,
    their GP features [n, F] and a target: -> (x, y, (n_cont, n_cat)),
    n_cont None where the space has no categorical lane."""
    from uptune_tpu_torch import rng
    from uptune_tpu_torch.exec.space_io import space_from_params
    space = space_from_params(wide_records(kind))
    cands = space.random(rng.generator(seed, dev), n)
    x = space.surrogate_transform(space.features(cands))
    nc, ncat = space.n_cont_features, space.n_cat
    # smooth in both blocks, so the fitted lengthscales are long and the
    # kernel rows far from 0: the continuous lanes' mean and the share
    # of categorical lanes at their first code
    y = torch.zeros(n, device=dev)
    if nc:
        y = y + 4.0 * x[:, :nc].mean(1)
    if ncat:
        y = y + x[:, nc::space.cat_max_codes].mean(1)
    return x.contiguous(), y, (nc if ncat else None, ncat)


def wide_case(name: str, st, xq, best: float, nc: int, ncat: int,
              k: int) -> dict:
    """A-D against their plain versions on one state: each value's error
    over the stated tolerance (GP-standardized units), each side's
    distance from float64 from the same operands, D's index mismatches
    and whether its picks are a float64 top k.  A row passes at the
    nominal tolerance, or where K^-1 is ill-conditioned within the
    tolerance of float64 or TF32_ERROR_RATIO times the plain version's
    distance from it (the surrogate_driver phase's rule)."""
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import pallas_score as ps
    blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
    ys, ym = float(st.y_std), float(st.y_mean)

    def moments(mu_n, q=None):
        return ps.target_moments(mu_n, q, st.noise, st.y_mean, st.y_std)

    def limit(tol, v):
        return tol["atol"] + tol["rtol"] * v.double().abs()
    b64 = [None if t is None else t.double() for t in blocks]
    mu64, q64 = ps.tile_moments(ps.kernel_tile(*b64[:4]), b64[4],
                                kinv.double())
    m64, s64 = moments(mu64, q64)
    u64 = acq.utilities(mu64, q64, params.double(), "ei")
    mw, sw = moments(*ps.mean_var_tile_plain(*blocks, kinv))
    lim = {"mean": limit(MEAN_TOL, (mw - ym) / ys),
           "sd": limit(SD_TOL, sw / ys)}
    lim["ei"] = lim["mean"] + lim["sd"]
    mg, sg = moments(*ps.mean_var_tile_cuda(*blocks, kinv))
    vg, ig = acq.topk_cuda(*blocks, kinv, params, "ei", k)
    vw, iw = acq.topk_plain(*blocks, kinv, params, "ei", k)
    checks = {
        ("gp_mean", "mean"): (moments(ps.mean_tile_cuda(*blocks))[0],
                              moments(ps.mean_tile_plain(*blocks))[0],
                              lim["mean"], m64, m64),
        ("gp_mean_var", "mean"): (mg, mw, lim["mean"], m64, m64),
        ("gp_mean_var", "sd"): (sg, sw, lim["sd"], s64, s64),
        ("acquire_scores", "ei"): (
            acq.scores_cuda(*blocks, kinv, params, "ei"),
            acq.utilities_plain(*blocks, kinv, params, "ei"), lim["ei"],
            u64, u64),
        ("acquire_topk", f"ei k={k} values"): (
            vg, vw, lim["ei"][iw.long()], u64[ig.long()], u64[iw.long()]),
    }
    out = {"case": name, "rows": int(xq.shape[0]),
           "train_rows": int(st.x.shape[0]), "features": int(xq.shape[1]),
           "noise": float(st.noise), "checks": []}
    ok = True
    for (kernel, what), (got, want, lm, ref_g, ref_w) in checks.items():
        def over(a, b):
            return float(((a.double() - b.double()).abs() / ys / lm).max())
        c = {"kernel": kernel, "what": what,
             "max_abs_err": float((got.double() - want.double()).abs().max()),
             "err_over_tol": over(got, want),
             "kernel_f64_err_over_tol": over(got, ref_g),
             "plain_f64_err_over_tol": over(want, ref_w)}
        c["ok"] = c["err_over_tol"] <= 1 or c["kernel_f64_err_over_tol"] <= max(
            1.0, TF32_ERROR_RATIO * c["plain_f64_err_over_tol"])
        out["checks"].append(c)
        ok = ok and c["ok"]
    slack = 2 * max(float((vg.double() - u64[ig.long()]).abs().max()),
                    float((vw.double() - u64[iw.long()]).abs().max()))
    out["topk_index_mismatches"] = topk_index_mismatches(
        iw, vw / ys, ig, SD_TOL)
    out["topk_picks_f64_ok"] = bool(
        u64[ig.long()].min() >= torch.sort(u64, descending=True)
        .values[k - 1] - slack)
    out["topk_descending"] = bool((vg[1:] <= vg[:-1]).all())
    out["ok"] = ok and out["topk_descending"] and (
        not out["topk_index_mismatches"] or out["topk_picks_f64_ok"])
    return out


def gp_wide_phase(dev) -> dict:
    """Launchers A-D at the gcc space's F = 1028 (96 + 233 x 4), past the
    widths one block took before krows and A chunked the features: a GP
    fitted by `fit_auto_bucketed` on 1024 configurations drawn from that
    space, held against the plain versions at the main shapes (B 6040,
    N 1024, k 128) and at the manager's (B 4096, N 32-256, k 32), and at
    the main shapes a continuous-only and a categorical-only state of
    WIDE_SINGLE lanes (the single-kind instances); then
    kernel, plain and library times and the bound at the main shapes and
    D's at each manager bucket."""
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.surrogate import gp
    from uptune_tpu_torch.surrogate import pallas_score as ps
    x, y, (nc, ncat) = wide_surrogate("gcc", WIDE_N_TRAIN, SEED + 41, dev)
    xq, _, _ = wide_surrogate("gcc", 6040, SEED + 42, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    main = gp.precompute_kinv(gp.fit_auto_bucketed(
        x, y, max_points=WIDE_N_TRAIN, n_cont=nc, n_cat=ncat))
    torch.cuda.synchronize()
    out = {"phase": "gp_wide", "features": int(x.shape[1]), "n_cont": nc,
           "n_cat": ncat, "fit_auto_bucketed_s": time.perf_counter() - t0,
           "limits": {kern.name: kern.query(kern.limit, int(x.shape[1]), 1)
                      for kern in (ps.MEAN_KERNEL, ps.MEAN_VAR_KERNEL,
                                   acq.SCORES_KERNEL, acq.TOPK_KERNEL)},
           "cases": []}
    out["cases"].append(wide_case(f"gcc_f{x.shape[1]}_n{WIDE_N_TRAIN}",
                                  main, xq, float(y.min()), nc, ncat, TOP_K))
    # the training rows themselves, each continuous lane moved by +-NEAR:
    # the categorical distances are 0 and the continuous ones tiny, where
    # |q|^2 + |x|^2 - 2 q.x cancels the most and the sd is smallest
    gen = torch.Generator().manual_seed(SEED + 45)
    near = x.clone()
    near[:, :nc] += NEAR * (torch.randint(0, 2, (WIDE_N_TRAIN, nc),
                                          generator=gen) * 2.0 - 1.0).to(dev)
    out["cases"].append(wide_case(
        f"gcc_f{x.shape[1]}_near_training", main, near.contiguous(),
        float(y.min()), nc, ncat, TOP_K))
    nb, nkinv, _ = acq.prep(main, near.contiguous(), "ei", 0.0, BETA, nc,
                            ncat)
    out["cases"][-1]["min_sd_over_y_std"] = float(ps.target_moments(
        *ps.mean_var_tile_plain(*nb, nkinv), main.noise, main.y_mean,
        main.y_std)[1].min() / main.y_std)
    mq = xq[:WIDE_MANAGER_B].contiguous()
    states = {}
    for n in WIDE_MANAGER_N:
        states[n] = gp.precompute_kinv(gp.fit_auto_bucketed(
            x[:n], y[:n], max_points=WIDE_N_TRAIN, n_cont=nc, n_cat=ncat))
        out["cases"].append(wide_case(
            f"gcc_f{x.shape[1]}_manager_n{n}", states[n], mq,
            float(y[:n].min()), nc, ncat, WIDE_MANAGER_K))
    # each block alone past the widths one block took (krows'
    # <kCont only> / <kCat only> and A's single-kind streamed instances)
    singles = {}
    for i, kind in enumerate(("cont", "cat")):
        xs, ys, (ncs, ncats) = wide_surrogate(kind, WIDE_N_TRAIN,
                                              SEED + 43 + 2 * i, dev)
        xqs, _, _ = wide_surrogate(kind, 6040, SEED + 44 + 2 * i, dev)
        st = gp.precompute_kinv(gp.fit_auto_bucketed(
            xs, ys, max_points=WIDE_N_TRAIN, n_cont=ncs, n_cat=ncats))
        singles[kind] = (st, xqs, float(ys.min()), ncs, ncats)
        out["cases"].append(wide_case(
            f"{kind}_f{xs.shape[1]}_n{WIDE_N_TRAIN}", *singles[kind], TOP_K))
    # krows' route by width, as the library plans it: the CUDA cores up
    # to 361 features, the tensor cores past that
    routes = {f: ps.krows_route(f) for f in KROWS_ROUTE_WIDTHS}
    out["krows_route"] = {str(f): r for f, r in routes.items()}
    bad = [c for c in out["cases"] if not c["ok"]]
    if routes != {f: "tensor_cores" if f > 361 else "cuda_cores"
                  for f in KROWS_ROUTE_WIDTHS}:
        bad.append(f"krows routes {routes}")
    if bad or min(out["limits"].values()) < WIDE_N_TRAIN:
        emit(out)
        raise AssertionError(f"gp kernels at F={x.shape[1]}: {bad}, "
                             f"limits {out['limits']}")

    blocks, kinv, params = acq.prep(main, xq, "ei", float(y.min()), BETA,
                                    nc, ncat)
    b, f = xq.shape
    n = WIDE_N_TRAIN
    shape = f"B={b} N={n} F={f} (Fc={nc} Fk={f - nc})"
    bounds = launcher_bounds(b, n, f, shape)
    main_case = out["cases"][0]["checks"]
    plain = plain_calls(blocks, kinv, params)
    times = {}
    for name, kern in launcher_calls(blocks, kinv, params).items():
        bound, shp = bounds[name]
        times[name] = dict(
            bound, shape=shp,
            max_err_over_tol=max(c["err_over_tol"] for c in main_case
                                 if c["kernel"] == name),
            ms=median_ms(kern, reps=20),
            plain_ms=median_ms(plain[name][0], reps=10),
            library_ms=median_ms(plain[name][1], reps=10))
    manager = {}
    for n, st in states.items():
        blocks, kinv, params = acq.prep(st, mq, "ei", float(y[:n].min()),
                                        BETA, nc, ncat)
        k = WIDE_MANAGER_K
        manager[n] = dict(
            gp_bound(WIDE_MANAGER_B, n, f, True, 8 * k + 20),
            shape=f"B={WIDE_MANAGER_B} N={n} F={f} kind=ei k={k}",
            ms=median_ms(lambda: acq.topk_cuda(*blocks, kinv, params, "ei",
                                               k), reps=20),
            plain_ms=median_ms(lambda: acq.topk_plain(
                *blocks, kinv, params, "ei", k), reps=10),
            library_ms=median_ms(lambda: acq.select_topk(
                acq.utilities_ref(*blocks, kinv, params, "ei"), k),
                reps=10))
    single_timed = {}
    for kind, (st, xqs, best, ncs, ncats) in singles.items():
        blocks, kinv, params = acq.prep(st, xqs, "ei", best, BETA, ncs,
                                        ncats)
        b, fs = xqs.shape
        fns = {"gp_mean": (lambda: ps.mean_tile_cuda(*blocks), False,
                           4 * b),
               "gp_mean_var": (lambda: ps.mean_var_tile_cuda(*blocks, kinv),
                               True, 8 * b),
               "acquire_scores": (lambda: acq.scores_cuda(
                   *blocks, kinv, params, "ei"), True, 4 * b + 20),
               "acquire_topk": (lambda: acq.topk_cuda(
                   *blocks, kinv, params, "ei", TOP_K), True,
                   8 * TOP_K + 20)}
        single_timed[kind] = {
            name: dict(gp_bound(b, WIDE_N_TRAIN, fs, var, nbytes),
                       shape=f"B={b} N={WIDE_N_TRAIN} F={fs} ({kind} only)",
                       ms=median_ms(fn, reps=20))
            for name, (fn, var, nbytes) in fns.items()}
    out["timed"], out["topk_manager_timed"] = times, manager
    out["single_kind_timed"] = single_timed
    emit(out)
    out["main_state"] = (main, xq, float(y.min()), nc, ncat)
    return out


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
    launches = kernel_launches()
    rng_block = {"launches": native.RNG.launches,
                 "elements": native.RNG.elements}
    simplex_launches = native.SIMPLEX.launches

    best = eng.best_qor(st)
    de = st.tstates[0]
    out = {"phase": "engine", "scale": SCALE, "rows_per_step": rows,
           "history_capacity": CAPACITY, "steps": STEPS,
           "seconds": wall, "ms_per_step": wall / STEPS * 1e3,
           "acquisitions_per_s": rows * STEPS / wall,
           "init_and_warm_step_s": warm_s, "best_qor": best,
           "evals": int(st.evals), "acqs": int(st.acqs),
           "hist_n": int(st.hist.n), "hist_dropped": int(st.hist.dropped),
           "launches": launches, "rng_block": rng_block,
           "simplex_propose": simplex_launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    # a step draws from three blocks: the key split, the proposal's and
    # the observe's
    if rng_block["launches"] != 3 * STEPS:
        raise AssertionError(f"rng kernel launched {rng_block} in {STEPS} "
                             f"steps, not 3 a step")
    # one NelderMead among the arms: one proposal a step
    if simplex_launches != STEPS:
        raise AssertionError(f"simplex kernel launched {simplex_launches} "
                             f"times in {STEPS} steps, not 1 a step")
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
    launches = kernel_launches()

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
    # one features launch a scored step and a propose_topk
    want = {"acquire_scores": SURR_STEPS, "acquire_topk": TOPK_EPOCHS,
            "gp_mean": FLAT_STEPS, "gp_mean_var": FLAT_STEPS,
            "merge_rows": SURR_STEPS + 2 * FLAT_STEPS,
            "surrogate_features": SURR_STEPS + TOPK_EPOCHS + 2 * FLAT_STEPS}
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
        launches = kernel_launches()
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
        want = dict.fromkeys(kernel_launches(), 0)
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
    launches = kernel_launches()
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
    want = dict.fromkeys(kernel_launches(), 0)
    want.update(acquire_scores=BF_STEPS, merge_rows=BF_STEPS,
                surrogate_features=BF_STEPS)
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
    launches = kernel_launches()

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
    want = dict.fromkeys(kernel_launches(), 0)
    want.update(merge_rows=PF_STEPS + PF_SCORED, acquire_scores=PF_SCORED,
                surrogate_features=PF_SCORED)
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
    launches = kernel_launches()
    out.update({
        "seconds": wall, "ms_per_step": wall / PB_STEPS * 1e3,
        "acquisitions_per_s": PB_N * b * PB_STEPS / wall,
        "best_qor": float(be.best_qors(st).min()),
        "evals": int(st.evals.sum()), "acqs": int(st.acqs.sum()),
        "hist_dropped": int(st.hist.dropped.sum()), "launches": launches,
        "all_equal_after_exchange": exchanged,
        "syncs_per_step": sync_count(lambda: be.run(st, 1))})
    want = dict.fromkeys(kernel_launches(), 0)
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
    launches = kernel_launches()
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
    want = dict.fromkeys(kernel_launches(), 0)
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
           "launches": kernel_launches(),
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
        want = dict.fromkeys(kernel_launches(), 0)
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


# -- program mode ----------------------------------------------------------------

def ut_cli(args, cwd, timeout: float = 600.0):
    """`python -m uptune_tpu_torch.cli *args` in `cwd`, as a user runs it
    from a checkout: -> (CompletedProcess, wall seconds)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "uptune_tpu_torch.cli",
                        *args], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return r, time.perf_counter() - t0


def read_archive(path) -> list:
    return [json.loads(x) for x in open(path)][1:]


def distinct_cfgs(rows) -> int:
    return len({json.dumps(r["cfg"], sort_keys=True) for r in rows})


# the controller's closing log lines (exec/controller.py): builds launched
# and the driver's time behind the builds
STORE_LOG = re.compile(r"store: (\d+) build\(s\) eliminated by cache hits, "
                       r"(\d+) launched")
POOL_LOG = re.compile(r"pool utilization=([\d.]+) \(driver t_propose="
                      r"([\d.]+)s t_dedup=([\d.]+)s behind t_eval_wait="
                      r"([\d.]+)s")


def cli_run(args, cwd, bad: list, what: str) -> dict:
    """One CLI tune: its result line, seconds, builds launched and the
    driver's time behind the builds, from its output."""
    r, wall = ut_cli(args, cwd)
    out = {"args": " ".join(args), "returncode": r.returncode,
           "seconds": wall}
    if r.returncode != 0:
        bad.append(f"{what}: exit {r.returncode}: {r.stderr[-1500:]}")
        return out
    out.update(json.loads(r.stdout.strip().splitlines()[-1]))
    m, p = STORE_LOG.search(r.stderr), POOL_LOG.search(r.stderr)
    if m:
        out["store_hits"], out["builds_launched"] = int(m[1]), int(m[2])
    if p:
        out.update(pool_utilization=float(p[1]), t_propose_s=float(p[2]),
                   t_dedup_s=float(p[3]), t_eval_wait_s=float(p[4]))
    out["trials_per_s"] = out["evals"] / wall
    return out


def program_tuner(d: Path, dev, seed: int, **kw):
    """The port's ProgramTuner on d/rosenbrock.py on `dev` with a
    recorder of its StepStats and a count of its commits: (tuner,
    stats, commits)."""
    from uptune_tpu_torch.driver.plugins import SearchHook
    from uptune_tpu_torch.exec import ProgramTuner

    class Steps(SearchHook):
        def __init__(self):
            self.stats = []

        def on_step(self, tuner, stats):
            self.stats.append(stats)
    rec, commits = Steps(), [0]
    pt = ProgramTuner([sys.executable, str(d / "rosenbrock.py")], str(d),
                      seed=seed, device=dev, hooks=[rec],
                      env={"PYTHONPATH": str(ROOT)}, **kw)
    make = pt._make_tuner

    def counted_tuner(space):
        t = make(space)
        commit = t._commit

        def counted(*args):
            commits[0] += 1
            commit(*args)
        t._commit = counted
        return t
    pt._make_tuner = counted_tuner
    return pt, rec.stats, commits


def traced_program_run(pt, stats, commits, d: Path, bad: list) -> dict:
    """Run a one-worker ProgramTuner traced, with the tuning journal on:
    the exported trace passes `validate_trace`, the journal's step rows
    number the tickets (the committing ones are those that evaluated a
    trial), and the children's sidecar spans land on the worker lane,
    one child.target a build.  -> its numbers."""
    from uptune_tpu_torch import obs
    jpath, tpath = d / "run.journal.jsonl", d / "run.trace.json"
    obs.reset()
    obs.enable()
    mon = obs.start_journal(str(jpath))
    t0 = time.perf_counter()
    try:
        pt.run()
    finally:
        obs.stop_journal(mon)
    wall = time.perf_counter() - t0
    doc = obs.write_trace(str(tpath))
    evs = obs.snapshot()["events"]
    obs.reset()
    obs.validate_trace(json.load(open(tpath)))
    _, rows = obs.journal.read(str(jpath), strict=True)
    steps = [r for r in rows if r["ev"] == "step"]
    child = [e for e in evs if e["name"].startswith("child.")]
    out = {"seconds": wall, "trace_events": len(doc["traceEvents"]),
           "trace_bytes": tpath.stat().st_size,
           "journal_rows": len(rows), "step_rows": len(steps),
           "tickets": len(stats), "commits": commits[0],
           "builds": pt.pool.launched,
           "child_events": len(child),
           "child_lanes": sorted({e["track"] for e in child}),
           "child_targets": sum(e["name"] == "child.target"
                                for e in child)}
    if not ([r["step"] for r in steps] == list(range(1, len(stats) + 1))
            and sum(1 for r in steps if r["evaluated"]) == commits[0]
            and out["child_lanes"] == ["worker-0"]
            and out["child_targets"] == pt.pool.launched):
        bad.append(f"traced program run: {out}")
    return out


def program_phase(dev) -> dict:
    """Program mode on the card (see the module docstring): the unchanged
    rosenbrock sample through the port's CLI, its resume and the same
    tune on the CPU; the ProgramTuner in process (launches, syncs a
    ticket, the driver's time behind the builds), and lockstep archives
    whichever package the child imports; the gcc-options sample at full
    width with the calibrated GP."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    from uptune_tpu_torch import cli, native
    from uptune_tpu_torch.exec import controller
    out = {"phase": "program"}
    bad = []
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="ut_program_"))
    samples = ROOT / "samples"

    def copy_sample(name, sub):
        d = tmp / sub
        shutil.copytree(samples / name, d, ignore=shutil.ignore_patterns(
            ".gcc_space_cache*", ".anchor_*", "ut.*", "best*.json",
            "__pycache__"))
        return d
    try:
        # (a) the user's entry point, the unchanged sample, on the card
        # (the default), then resumed; the same tune on the CPU beside it
        d = copy_sample("rosenbrock", "cli_card")
        first = cli_run(["rosenbrock.py", "-pf", "4", "--test-limit",
                         str(CLI_LIMIT), "--seed", "0"], d, bad, "cli")
        if first["returncode"] == 0:
            rows = read_archive(d / "ut.archive.jsonl")
            # the stats phase reads this archive after the phase's files
            # are gone
            keep = Path(tempfile.mkdtemp(prefix="ut_stats_"))
            shutil.copy(d / "ut.archive.jsonl", keep)
            out["archive"] = str(keep / "ut.archive.jsonl")
            dq = json.load(open(d / "ut.default_qor.json"))["qor"]
            best = json.load(open(d / "best.json"))
            first.update(default_qor=dq, archive_rows=len(rows),
                         distinct_configs=distinct_cfgs(rows))
            if not (np.isfinite(first["best_qor"])
                    and first["best_qor"] <= dq
                    and len(rows) == CLI_LIMIT == first["evals"]
                    and first["distinct_configs"] == CLI_LIMIT
                    and best == {"config": first["best_config"],
                                 "qor": first["best_qor"]}):
                bad.append(f"cli tune: {first}, best.json {best}")
            resumed = cli_run(["rosenbrock.py", "-pf", "4", "--test-limit",
                               str(CLI_RESUME), "--seed", "0",
                               "--resume"], d, bad, "cli resume")
            if resumed["returncode"] == 0:
                rows2 = read_archive(d / "ut.archive.jsonl")
                resumed.update(archive_rows=len(rows2),
                               distinct_configs=distinct_cfgs(rows2))
                if not (rows2[:CLI_LIMIT] == rows
                        and len(rows2) == CLI_RESUME
                        and resumed["distinct_configs"] == CLI_RESUME
                        and resumed.get("builds_launched", 1 << 30)
                        <= CLI_RESUME - CLI_LIMIT
                        and resumed["best_qor"] <= first["best_qor"]):
                    bad.append(f"cli resume: {resumed}")
            out["cli_resume"] = resumed
        out["cli"] = first
        dc = copy_sample("rosenbrock", "cli_cpu")
        out["cli_cpu"] = cli_run(["rosenbrock.py", "-pf", "4", "--test-limit",
                                  str(CLI_LIMIT), "--seed", "0",
                                  "--device", "cpu"], dc, bad, "cli cpu")

        # (b) in process on the card: launches, host syncs a ticket, the
        # driver's time behind the builds
        d = copy_sample("rosenbrock", "in_process")
        pt, stats, commits = program_tuner(d, dev, 0, parallel=4,
                                           test_limit=PROGRAM_LIMIT)
        torch.cuda.synchronize()
        native.reset_launches()               # the main path's run starts here
        res = []
        t0 = time.perf_counter()
        syncs = sync_count(lambda: res.append(pt.run()), 2)
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        tickets = len(stats)
        want = dict.fromkeys(kernel_launches(), 0)
        want["merge_rows"] = commits[0]
        inproc = {
            "device": str(dev), "parallel": 4, "test_limit": PROGRAM_LIMIT,
            "evals": res[0].evals, "best_qor": res[0].best_qor,
            "seconds": wall, "trials_per_s": res[0].evals / wall,
            "tickets": tickets, "commits": commits[0], "launches": launches,
            "syncs_per_ticket": {k: v / max(tickets, 1)
                                 for k, v in syncs.items()},
            "syncs_per_ticket_total": sum(syncs.values()) / max(tickets, 1),
            "t_propose_median_ms": statistics.median(
                s.t_propose for s in stats) * 1e3,
            "t_dedup_median_ms": statistics.median(
                s.t_dedup for s in stats) * 1e3,
            "t_eval_wait_median_ms": statistics.median(
                s.t_eval_wait for s in stats) * 1e3,
            "pool_utilization": pt.pool.utilization(),
            "builds_launched": pt.pool.launched}
        out["in_process"] = inproc
        if launches != want or not commits[0]:
            bad.append(f"program launches {launches}, expected {want}")
        if not np.isfinite(res[0].best_qor):
            bad.append(f"program best {res[0].best_qor}")

        # lockstep at one worker without prefetch: the same archive
        # whichever package the child imports; that child's import cost
        arcs = {}
        for pkg in ("uptune_tpu", "uptune_tpu_torch"):
            d = copy_sample("rosenbrock", f"lockstep_{pkg}")
            src = (d / "rosenbrock.py").read_text()
            (d / "rosenbrock.py").write_text(src.replace(
                "import uptune_tpu as ut", f"import {pkg} as ut"))
            p1, st1, c1 = program_tuner(d, dev, 1, parallel=1, prefetch=0,
                                        test_limit=PROGRAM_LOCKSTEP)
            if pkg == "uptune_tpu_torch":
                # the port's child, the run traced with the journal on:
                # its archive must still equal the untraced run's
                out["traced"] = traced_program_run(p1, st1, c1, d, bad)
            else:
                p1.run()
            arcs[pkg] = [(r["cfg"], r["qor"])
                         for r in read_archive(d / "ut.archive.jsonl")]
        code = ("import sys, time; t = time.perf_counter(); "
                "import uptune_tpu_torch as ut; ut.tune; ut.target; "
                "print(time.perf_counter() - t, 'torch' in sys.modules)")
        import os
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env=dict(os.environ,
                                               PYTHONPATH=str(ROOT)))
        secs, torch_in = r.stdout.split()
        out["lockstep"] = {
            "trials": len(arcs["uptune_tpu_torch"]),
            "archives_equal": arcs["uptune_tpu"] == arcs["uptune_tpu_torch"],
            "child_import_s": float(secs),
            "child_imports_torch": torch_in == "True"}
        if not (out["lockstep"]["archives_equal"]
                and out["lockstep"]["trials"] == PROGRAM_LOCKSTEP
                and torch_in == "False"):
            bad.append(f"lockstep: {out['lockstep']}")

        # (c) the gcc-options sample at full width: the machine's g++
        # mined first (timed), then the tune through the CLI's main in
        # process, with the calibrated GP and async refits
        g = copy_sample("gcc-options", "gcc")
        mine = ("import json, time, mine_gcc; t = time.perf_counter(); "
                "m = mine_gcc.mine(); print(json.dumps({'seconds': "
                "time.perf_counter() - t, 'version': m['version'], "
                "'flags': len(m['flags']), 'params': len(m['params'])}))")
        r = subprocess.run([sys.executable, "-c", mine], cwd=g,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise AssertionError(f"mining g++ failed: {r.stderr[-1500:]}")
        gcc = {"mining": json.loads(r.stdout.strip().splitlines()[-1])}
        made = []
        make = controller.ProgramTuner._make_tuner

        def recorded(self, space):
            t = make(self, space)
            made.append((self, t))
            return t
        controller.ProgramTuner._make_tuner = recorded
        native.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main([str(g / "tune_gcc.py"), "--learning-models",
                               "gp", "-pf", "4", "--test-limit",
                               str(GCC_LIMIT), "--runtime-limit", "120"])
        finally:
            controller.ProgramTuner._make_tuner = make
        gcc["seconds"] = time.perf_counter() - t0
        gcc["returncode"] = rc
        if rc != 0 or not made:
            raise AssertionError(f"gcc-options tune: exit {rc}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        gpt, t = made[0]
        sm = t.surrogate
        gcc.update(
            params=len(t.space.specs), n_cont=t.space.n_cont_features,
            n_cat=t.space.n_cat, features=t.space.n_surrogate_features,
            evals=line["evals"], best_qor=line["best_qor"],
            default_qor=gpt.default_qor, builds_launched=gpt.pool.launched,
            store_hits=gpt.store_hits, tickets=t.steps,
            pool_utilization=gpt.pool.utilization(),
            refits_started=sm.refits_started, refits_published=sm.refits,
            extensions=sm.incr_updates,
            launches=kernel_launches())
        out["gcc"] = gcc
        if not (np.isfinite(line["best_qor"]) and line["evals"] >= GCC_LIMIT
                and gcc["launches"]["acquire_topk"] == 0
                and gcc["launches"]["merge_rows"] > 0
                and gcc["features"] >= 1028):
            bad.append(f"gcc-options tune: {gcc}")

        # (d) the C++ header client's demo (cpp/demo), built with g++,
        # tuned by the ProgramTuner on the card; its best applied back
        # through the client's BEST mode
        out["cpp"] = cpp_demo_run(tmp / "cpp", dev, bad)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("program mode: " + "; ".join(bad))
    return out


def cpp_demo_run(work: Path, dev, bad: list) -> dict:
    """cpp/demo/demo_tune.cc tuned for CPP_LIMIT trials (see
    program_phase)."""
    import os

    from uptune_tpu_torch import native
    from uptune_tpu_torch.exec import ProgramTuner
    work.mkdir(parents=True)
    demo = work / "demo_tune"
    t0 = time.perf_counter()
    subprocess.run(["g++", "-std=c++11", "-O2", "-Wall", "-Wextra", "-Werror",
                    "-I", str(ROOT / "cpp" / "include"), "-o", str(demo),
                    str(ROOT / "cpp" / "demo" / "demo_tune.cc")],
                   check=True, capture_output=True, text=True, timeout=300)
    out = {"build_seconds": time.perf_counter() - t0, "trials": CPP_LIMIT}
    pt = ProgramTuner([str(demo)], str(work), parallel=2,
                      test_limit=CPP_LIMIT, runtime_limit=60.0, seed=3,
                      device=dev)
    params = [r["name"] for r in pt.analyze()[0]]
    native.reset_launches()
    t0 = time.perf_counter()
    res = pt.run()
    out.update(params=params, default_qor=pt.default_qor, evals=res.evals,
               best_qor=res.best_qor, best_config=res.best_config,
               seconds=time.perf_counter() - t0,
               launches=kernel_launches())
    r = subprocess.run([str(demo)], capture_output=True, text=True,
                       cwd=str(work), timeout=60,
                       env=dict(os.environ, BEST="True",
                                UT_WORK_DIR=str(work)))
    applied = (int(r.stdout.split("block=")[1].split()[0])
               if r.returncode == 0 and "block=" in r.stdout else None)
    out["best_applied_block"] = applied
    if not (params == ["block", "alpha", "unroll", "opt"]
            and abs(pt.default_qor - 7.4) < 1e-6
            and res.evals >= CPP_LIMIT and res.best_qor <= 7.4
            and applied == res.best_config["block"]
            and out["launches"]["merge_rows"] > 0
            and out["launches"]["acquire_topk"] == 0):
        bad.append(f"C++ demo: {out}")
    return out


def obs_phase(engine, prog: dict, cases, dev) -> dict:
    """The observability plane on the card (see the module docstring):
    the program phase's traced run, the driver's Tuner with obs off and
    with trace + journal on in turns, one `record_window` of the
    surrogate-scored flagship step against the H100 peaks, and a
    `--device-trace` capture."""
    import shutil
    import tempfile

    from uptune_tpu_torch import obs
    from uptune_tpu_torch.engine.batched import surrogate_eval_fn
    out = {"phase": "obs", "program": prog["traced"]}
    bad = []
    tmp = Path(tempfile.mkdtemp(prefix="ut_obs_"))
    try:
        # (a) the driver phase's Tuner (the same tune each time), obs off
        # and with trace + journal on, in turns; the bar is the JAX
        # package's: traced throughput >= 0.95x of untraced
        warm, _, _ = driver_tuner(dev, DRIVER_CAP, SEED + 30)
        warm.run(test_limit=DRIVER_WARM)
        ms = {"off": [], "on": []}
        for i, mode in enumerate(("off", "on", "on", "off")):
            t, stats, _ = driver_tuner(dev, DRIVER_CAP, SEED + 31)
            mon = None
            if mode == "on":
                obs.reset()
                obs.enable()
                mon = obs.start_journal(str(tmp / f"driver{i}.jsonl"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.run(test_limit=DRIVER_LIMIT)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if mode == "on":
                obs.stop_journal(mon)
                doc = obs.chrome_trace()
                obs.validate_trace(doc)
                out["driver_trace_events"] = len(doc["traceEvents"])
                obs.reset()
            ms[mode].append(dt * 1e3 / len(stats))
            t.close()
        out["driver"] = {
            "tickets": len(stats), "ms_per_ticket_off": ms["off"],
            "ms_per_ticket_on": ms["on"],
            "throughput_ratio": statistics.mean(ms["off"])
            / statistics.mean(ms["on"]),
            "bar": 0.95}

        # (b) the surrogate-scored flagship step (launcher C a step)
        # through the instrumented engine.run, one window against the
        # H100 peaks; its cost is C's counted work
        eng, st, _ = engine
        st_gp, xq, best, nc, ncat = cases["mixed_n1024"]
        ev = surrogate_eval_fn(eng.space, st_gp, kind="ei", best_y=best,
                               impl="fused", n_cont=nc, n_cat=ncat)
        eng.run(st, 1, eval_fn=ev)                  # warm
        cost = gp_bound(xq.shape[0], st_gp.x.shape[0], xq.shape[1], True,
                        4 * xq.shape[0] + 20)
        obs.reset()
        obs.enable()
        obs.device.set_cost("engine.run", {
            "flops": cost["flops"] * OBS_STEPS,
            "bytes_accessed": cost["bytes"] * OBS_STEPS})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(st, OBS_STEPS, eval_fn=ev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        win = obs.device.record_window("engine.run", wall)
        prog_rec = obs.device.programs()["engine.run"]
        out["record_window"] = {
            "program": "engine.run", "steps": OBS_STEPS,
            "device_kind": torch.cuda.get_device_name(0),
            "wall_ms_per_step": wall * 1e3 / OBS_STEPS,
            "cost": "launcher C's counted FLOPs and bytes a step "
                    "(gp_bound); the step's other ops are not counted",
            **win}
        if not (win.get("peak_flops_per_s") and "mxu_util" in win
                and prog_rec["dispatches"] == 1):
            bad.append(f"record_window: {out['record_window']}")

        # (c) a --device-trace capture of a few of those steps: CUDA
        # kernels and the host spans' record_function ranges in one file
        d = tmp / "device_trace"
        obs.device.start_trace(str(d))
        eng.run(st, 3, eval_fn=ev)
        torch.cuda.synchronize()
        obs.device.stop_trace()
        host = obs.chrome_trace()
        obs.validate_trace(host)
        f = d / obs.device.TRACE_FILE
        devdoc = json.load(open(f))
        evs = devdoc.get("traceEvents", [])
        out["device_trace"] = {
            "bytes": f.stat().st_size, "events": len(evs),
            "kernel_events": sum(e.get("cat") == "kernel" for e in evs),
            "host_ranges": sum(e.get("name") == "engine.run" for e in evs),
            "referenced": host["otherData"].get("device_trace") == str(d)}
        obs.reset()
        if not (out["device_trace"]["kernel_events"]
                and out["device_trace"]["host_ranges"]
                and out["device_trace"]["referenced"]):
            bad.append(f"device trace: {out['device_trace']}")
    finally:
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    if bad:
        raise AssertionError("obs: " + "; ".join(bad))
    return out


# -- D over an instance axis -------------------------------------------------------
def topk_batched_phase(cases, feats: tuple, dev) -> dict:
    """Launcher D over an instance axis (see the module docstring): the
    batched flagship's N 4 x 6040 rows at k 128 and the manager's pool
    N 64 x 4096 at k 32, each segment's top k bitwise against its own
    single launch and within D's tolerances against `topk_plain`; the
    batched launch timed against N single launches, the plain version
    and the library staging, in turns; then `BatchedEngine.propose_topk`
    on the flagship at N 4 (the main path: one D launch an epoch)."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import BatchedEngine, surrogate_eval_fn
    from uptune_tpu_torch.flagship import flagship, flagship_surrogate
    from uptune_tpu_torch.ops import acquire as acq
    from uptune_tpu_torch.space.spec import CandBatch
    from uptune_tpu_torch.surrogate import pallas_score as ps
    nc, ncat = feats
    st, _, best, _, _ = cases["mixed_n1024"]
    n_train = int(st.x.shape[0])
    ys = float(st.y_std)
    out = {"phase": "topk_batched", "shapes": []}
    bad = []
    for segs, rows, k in TOPK_SEGMENTS:
        xq, _, _ = flagship_surrogate(segs * rows, SEED + 30 + segs, dev)
        blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
        seg_blocks = [type(blocks)(*(None if t is None else
                                     t[s * rows:(s + 1) * rows].contiguous()
                                     for t in blocks[:2]), *blocks[2:])
                      for s in range(segs)]
        vg, ig = acq.topk_segments_cuda(*blocks, kinv, params, "ei", k, segs)
        single = [acq.topk_cuda(*sb, kinv, params, "ei", k)
                  for sb in seg_blocks]
        plain = [acq.topk_plain(*sb, kinv, params, "ei", k)
                 for sb in seg_blocks]
        torch.cuda.synchronize()
        bitwise = all(torch.equal(vg[s], single[s][0])
                      and torch.equal(ig[s], single[s][1])
                      for s in range(segs))
        errs, miss = [], 0
        for s, (vw, iw) in enumerate(plain):
            errs.append(tol_excess(vg[s], vw, SD_TOL, ys))
            miss += topk_index_mismatches(iw, vw / ys, ig[s], SD_TOL)
        f = int(xq.shape[1])
        shape = (f"N={segs} x B={rows} N_train={n_train} F={f} kind=ei "
                 f"k={k}")
        bound = gp_bound(segs * rows, n_train, f, True, 8 * k * segs + 20)
        ms = median_ms(lambda: acq.topk_segments_cuda(
            *blocks, kinv, params, "ei", k, segs))
        singles_ms = median_ms(lambda: [acq.topk_cuda(
            *sb, kinv, params, "ei", k) for sb in seg_blocks])
        plain_ms = median_ms(lambda: [acq.topk_plain(
            *sb, kinv, params, "ei", k) for sb in seg_blocks])
        library_ms = median_ms(lambda: acq.select_topk(acq.utilities_ref(
            *blocks, kinv, params, "ei").reshape(segs, rows), k))
        # a second round in turns: the first numbers stand unless both
        # rounds are recorded
        ms2 = median_ms(lambda: acq.topk_segments_cuda(
            *blocks, kinv, params, "ei", k, segs))
        singles2 = median_ms(lambda: [acq.topk_cuda(
            *sb, kinv, params, "ei", k) for sb in seg_blocks])
        rec = dict(bound, shape=shape, segments=segs, rows=rows, k=k,
                   bitwise_against_single_launches=bitwise,
                   max_abs_err=max(e[0] for e in errs),
                   max_err_over_tol=max(e[1] for e in errs),
                   index_mismatches=miss,
                   descending=bool((vg[:, 1:] <= vg[:, :-1]).all()),
                   ms=ms, ms_second_round=ms2, single_launches_ms=singles_ms,
                   single_launches_ms_second_round=singles2,
                   plain_ms=plain_ms, library_ms=library_ms,
                   scratch_bytes=4 * ps.scratch_words(
                       acq.TOPK_KERNEL, rows, n_train, True, k, segs))
        out["shapes"].append(rec)
        if not (bitwise and rec["max_err_over_tol"] <= 1.0 and not miss
                and rec["descending"]):
            bad.append(f"{shape}: {rec}")

    # the main path: propose_topk on the flagship at N 4, counted
    eng = flagship(SCALE, history_capacity=CAPACITY, device=dev)
    ev = surrogate_eval_fn(eng.space, st, kind="ei", best_y=best,
                           impl="fused", n_cont=nc, n_cat=ncat)
    be = BatchedEngine(eng, BF_N)
    st0 = be.init(SEED + 31)
    be.propose_topk(st0, TOP_K, ev)              # warm epoch
    torch.cuda.synchronize()
    native.reset_launches()                      # the main path starts here
    t0 = time.perf_counter()
    for _ in range(TOPK_EPOCHS):
        ts, cands, keys, vals, idx = be.propose_topk(st0, TOP_K, ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    want = dict.fromkeys(kernel_launches(), 0)
    want.update(acquire_topk=TOPK_EPOCHS, surrogate_features=TOPK_EPOCHS)
    # each instance's top k is that instance's own D launch
    own = [ev.topk(CandBatch(cands.u[i], tuple(p[i] for p in cands.perms)),
                   ev.aux, TOP_K) for i in range(BF_N)]
    gv, gown, gidx = be.global_topk(st0, TOP_K, ev)
    pool = torch.cat([v for v, _ in own])
    out["propose_topk"] = {
        "instances": BF_N, "rows_per_instance": eng.total_batch,
        "k": TOP_K, "epochs": TOPK_EPOCHS, "seconds": wall,
        "ms_per_epoch": wall / TOPK_EPOCHS * 1e3, "launches": launches,
        "own_launch_bitwise": all(
            torch.equal(vals[i], own[i][0]) and torch.equal(idx[i], own[i][1])
            for i in range(BF_N)),
        "global_rows_equal": bool((gv == gv[0]).all()
                                  and (gown == gown[0]).all()),
        "global_best": float(gv[0, 0]),
        "global_is_pool_max": float(gv[0, 0]) == float(pool.max())}
    p = out["propose_topk"]
    if launches != want:
        bad.append(f"propose_topk launches {launches}, expected {want}")
    if not (p["own_launch_bitwise"] and p["global_rows_equal"]
            and p["global_is_pool_max"]):
        bad.append(f"propose_topk: {p}")
    emit(out)
    if bad:
        raise AssertionError("D over an instance axis: " + "; ".join(bad))
    return out


# -- the serving plane ------------------------------------------------------------
class GpuBusy:
    """nvidia-smi's utilization.gpu (the share of its sample period in
    which a kernel of any process ran on the card) read every `every`
    seconds in a thread while a drive runs; no samples without
    nvidia-smi."""

    def __init__(self, every: float = 0.5):
        self.every, self.samples = every, []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.wait(self.every):
            try:
                r = subprocess.run(
                    ["nvidia-smi", "--query-gpu=utilization.gpu",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10)
                self.samples.append(float(r.stdout.split()[0]))
            except (OSError, ValueError, IndexError,
                    subprocess.SubprocessError):
                return

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(15)

    def summary(self) -> dict:
        v = sorted(self.samples)
        if not v:
            return {"samples": 0}
        return {"samples": len(v), "mean_pct": sum(v) / len(v),
                "p50_pct": v[len(v) // 2], "max_pct": v[-1]}


# the histograms a serving process keeps of where a request's time goes:
# the whole request, and the host dispatch of each instrumented engine
# call (obs.device.instrument)
SERVE_HISTS = ("serve.ask_ms", "serve.tell_ms", "device.dispatch_ms")


def serve_hists(hists: dict) -> dict:
    return {k: {f: hists[k].get(f) for f in ("count", "sum", "p50", "p95",
                                             "max")}
            for k in SERVE_HISTS if isinstance(hists.get(k), dict)}


class TimedLock:
    """A stand-in for a serve group's `threading.RLock` that times each
    outermost hold: the wait from asking to holding, and the seconds
    held (the serve phase's lock attribution; reentrant holds add
    nothing)."""

    def __init__(self):
        self.lock = threading.RLock()
        self.owner, self.depth, self.since = None, 0, 0.0
        self.waits, self.held = [], 0.0

    def acquire(self, blocking=True, timeout=-1):
        me = threading.get_ident()
        if self.owner == me:
            self.lock.acquire()
            self.depth += 1
            return True
        t0 = time.perf_counter()
        if not self.lock.acquire(blocking, timeout):
            return False
        self.since = time.perf_counter()
        self.waits.append(self.since - t0)
        self.owner, self.depth = me, 1
        return True

    def release(self):
        self.depth -= 1
        if not self.depth:
            self.held += time.perf_counter() - self.since
            self.owner = None
        self.lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def span_stats(events, name: str, since: float) -> dict:
    """count, sum, p50, p95 and max (ms) of the `name` spans recorded at
    or after `since` (seconds on the obs plane's clock)."""
    import numpy as np
    ms = np.sort(np.array([e["dur"] for e in events
                           if e["name"] == name and e["dur"] is not None
                           and e["ts"] >= since])) * 1e3
    if not len(ms):
        return {"count": 0}
    return {"count": len(ms), "sum_s": float(ms.sum()) / 1e3,
            "p50_ms": float(ms[len(ms) // 2]),
            "p95_ms": float(ms[int(len(ms) * 0.95)]),
            "max_ms": float(ms[-1])}


def serve_drive(dev, n_sessions: int, bad: list) -> dict:
    """The JAX package's serving protocol (`bench.py --serve`) against the
    port's SessionServer on `dev`: rosenbrock-4d, the default arms, one
    n_sessions-slot group, the memo store on, SERVE_EPOCHS barrier-
    separated epoch waves of chunked ask / tell_many over localhost TCP
    from T client threads, SERVE_CHURN closes and opens between epochs;
    one probe session drives an epoch alone first.  The merge's launches
    are read around the drive and must equal the server's commits.  Where
    the epoch waves' wall goes: the server's own `serve.commit` and
    `serve.propose` spans, each group's lock (`TimedLock`: waits and the
    share of the wall it is held) and the process's CPU seconds over the
    wall (the client threads and the server share one interpreter)."""
    import os
    import tempfile
    import numpy as np
    from uptune_tpu_torch import native, obs
    from uptune_tpu_torch.exec.space_io import records_from_space
    from uptune_tpu_torch.serve import SessionServer, connect
    from uptune_tpu_torch.workloads import rosenbrock_space
    dims, ask_n, hist = 4, 8, 256
    n_threads = max(4, min(16, 2 * (os.cpu_count() or 4)))
    n_threads = min(n_threads, n_sessions // 8)
    records = records_from_space(rosenbrock_space(dims, -3.0, 3.0))

    def measure_all(cfgs):
        x = np.array([[c[f"x{i}"] for i in range(dims)] for c in cfgs])
        return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                + (1 - x[:, :-1]) ** 2).sum(axis=1).tolist()

    store = tempfile.TemporaryDirectory(prefix="ut_serve_store_")
    srv = SessionServer(port=0, slots=n_sessions,
                        max_sessions=n_sessions + 64, store_dir=store.name,
                        device=dev).start()
    obs.metrics.reset()
    native.reset_launches()                 # the main path starts here
    lat_lock = threading.Lock()
    clients = [None] * n_threads
    handles = [None] * n_threads
    offered = {}                            # seed -> offered configs
    base, rem = divmod(n_sessions, n_threads)
    sampled = {}                            # session id -> seed

    def open_all(ti):
        # tenant 1 of the first 8 threads is a parity probe: it opens
        # without the memo, so every row of its epochs is offered to it
        c = connect(("127.0.0.1", srv.port))
        hs = [c.open_session(records, seed=ti * 10000 + j,
                             program="chip-serve", history_capacity=hist,
                             store=not (j == 1 and ti < 8))
              for j in range(base + (1 if ti < rem else 0))]
        clients[ti], handles[ti] = c, hs

    t0 = time.perf_counter()
    ts = [threading.Thread(target=open_all, args=(ti,))
          for ti in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    open_s = time.perf_counter() - t0
    group_rows = handles[0][0].info["batch"]
    locks = []
    for g in (g for gs in srv._groups.values() for g in gs):
        g.lock = TimedLock()                # idle: every open has returned
        locks.append(g.lock)
    for ti in range(min(8, n_threads)):     # never the probe or churned
        sampled[handles[ti][1].id] = ti * 10000 + 1

    def drive(hs, lats):
        n_asks = 0
        for h in hs:
            done = False
            while not done:
                a = time.perf_counter()
                trials = h.ask(ask_n)
                lats.append(time.perf_counter() - a)
                if not trials:
                    done = True
                    continue
                if h.id in sampled:
                    offered.setdefault(sampled[h.id], []).extend(
                        t.config for t in trials)
                n_asks += len(trials)
                r = h.tell_many(zip((t.ticket for t in trials),
                                    measure_all([t.config for t in trials])))
                done = bool(r.get("committed"))
        return n_asks

    # the probe: one session's epoch alone, at full width
    probe = handles[0][0]
    probe_lat = []
    drive([probe], probe_lat)
    epochs = SERVE_EPOCHS
    totals = [[0] * n_threads for _ in range(epochs)]
    epoch_lat = [[] for _ in range(epochs)]
    walls = [0.0] * epochs
    barrier = threading.Barrier(n_threads)
    errors = []

    def run_epochs(ti):
        try:
            c, hs = clients[ti], handles[ti]
            for e in range(epochs):
                barrier.wait()
                a = time.perf_counter()
                lats = []
                totals[e][ti] = drive(hs, lats)
                with lat_lock:
                    epoch_lat[e].extend(lats)
                barrier.wait()
                if ti == 0:
                    walls[e] = time.perf_counter() - a
                if e + 1 < epochs and ti < SERVE_CHURN:
                    hs[-1].close()
                    hs[-1] = c.open_session(
                        records, seed=ti * 10000 + 9000 + e,
                        program="chip-serve", history_capacity=hist)
        except BaseException as exc:
            errors.append(repr(exc))
            barrier.abort()
            raise

    for lk in locks:                        # the waves alone
        lk.waits, lk.held = [], 0.0
    obs_t0, cpu0 = obs.now(), time.process_time()
    t0 = time.perf_counter()
    ts = [threading.Thread(target=run_epochs, args=(ti,))
          for ti in range(n_threads)]
    with GpuBusy() as busy:
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    drive_s = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    trace = obs.snapshot()
    waits = np.sort(np.array([w for lk in locks for w in lk.waits])) * 1e3
    lock = {"acquisitions": len(waits),
            "wait_sum_s": float(waits.sum()) / 1e3,
            "wait_p50_ms": float(waits[len(waits) // 2]),
            "wait_p95_ms": float(waits[int(len(waits) * 0.95)]),
            "wait_max_ms": float(waits[-1]),
            "held_s": sum(lk.held for lk in locks)}
    lock["held_share_of_wall"] = lock["held_s"] / drive_s
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_launches()
    scrape = clients[0].metrics()
    counters = scrape["metrics"]["counters"]
    gauges = scrape["metrics"]["gauges"]
    groups = [g for gs in srv._groups.values() for g in gs]
    state_bytes = 0
    for g in groups:
        leaves = []
        from uptune_tpu_torch.engine.batched import _map
        _map(leaves.append, g.state)
        state_bytes += sum(t.numel() * t.element_size() for t in leaves)
    for ti in range(n_threads):
        c, hs = clients[ti], handles[ti]
        for i in range(0, len(hs), 128):
            c.batch([{"op": "close", "session": h.id}
                     for h in hs[i:i + 128]])
        c.close()
    srv.stop()
    store.cleanup()

    def pcts(lats):
        ms = np.sort(np.array(lats)) * 1e3
        return {"requests": len(ms), "p50_ms": float(ms[len(ms) // 2]),
                "p95_ms": float(ms[int(len(ms) * 0.95)]),
                "max_ms": float(ms[-1])}
    total = sum(sum(t) for t in totals)
    out = {"device": str(dev), "sessions": n_sessions, "threads": n_threads,
           "epochs": epochs, "churn_between_epochs": SERVE_CHURN,
           "rows_per_epoch": group_rows, "history_capacity": hist,
           "groups": len(groups), "open_s": open_s,
           "first_trial_ms": probe_lat[0] * 1e3,
           "probe": pcts(probe_lat), "drive_s": drive_s, "asks": total,
           "agg_asks_per_s": total / drive_s,
           "ask": pcts([v for lat in epoch_lat for v in lat]),
           "per_epoch": [dict(pcts(epoch_lat[e]), wall_s=walls[e],
                              agg_asks_per_s=sum(totals[e]) / walls[e])
                         for e in range(epochs)],
           "proposes": counters.get("serve.proposes", 0),
           "commits": counters.get("serve.commits", 0),
           "joins": counters.get("serve.joins", 0),
           "store_served": counters.get("serve.store_served", 0),
           "batch_fill_last": gauges.get("serve.batch_fill"),
           "server_ask_ms": scrape["metrics"]["hists"].get("serve.ask_ms"),
           "server_hists": serve_hists(scrape["metrics"]["hists"]),
           "gpu_busy": busy.summary(),
           # the epoch waves alone (after the probe)
           "commit_spans": span_stats(trace["events"], "serve.commit",
                                      obs_t0),
           "propose_spans": span_stats(trace["events"], "serve.propose",
                                       obs_t0),
           "spans_dropped": sum(trace["dropped"].values()),
           "group_lock": lock, "process_cpu_s": cpu_s,
           "process_cpu_over_wall": cpu_s / drive_s,
           "state_bytes": state_bytes, "launches": launches,
           "errors": errors, "sampled_seeds": sorted(offered)}
    want = dict.fromkeys(kernel_launches(), 0)
    if dev.type == "cuda":                  # the CPU merges in plain torch
        want["merge_rows"] = out["commits"]
    if errors or launches != want or not out["commits"]:
        bad.append(f"serve on {dev}: errors {errors}, launches {launches} "
                   f"against {want}")
    out["_offered"] = offered
    return out


def serve_phase(dev) -> dict:
    """The serving plane on the card and on the CPU (see the module
    docstring): the drive, sampled tenants bitwise against matched-seed
    LocalSessions on the card, and `ut-torch serve` as a subprocess."""
    import os
    import signal
    from uptune_tpu_torch.serve import LocalSession
    from uptune_tpu_torch.serve import connect
    from uptune_tpu_torch.workloads import rosenbrock_space
    bad = []
    out = {"phase": "serve"}
    card = serve_drive(dev, SERVE_SESSIONS, bad)
    offered = card.pop("_offered")
    # the sampled tenants against LocalSessions at matched seeds, on the
    # card: the same offered configs, in order, over the same epochs
    match = {}
    for seed, got in sorted(offered.items()):
        ls = LocalSession(rosenbrock_space(4, -3.0, 3.0), seed=seed,
                          history_capacity=256, device=dev)
        want = []
        while ls.version < SERVE_EPOCHS:
            trials = ls.ask(8)
            want.extend(t.config for t in trials)
            for t in trials:
                c = t.config
                x = [c[f"x{i}"] for i in range(4)]
                ls.tell(t.ticket, sum(100.0 * (x[i + 1] - x[i] ** 2) ** 2
                                      + (1 - x[i]) ** 2 for i in range(3)))
        ls.close()
        match[seed] = {"offered": len(got), "equal": got == want}
    card["sampled_equal_local_sessions"] = match
    if len(match) != 8 or not all(m["equal"] for m in match.values()):
        bad.append(f"sampled tenants differ from LocalSessions: {match}")
    out["card"] = card
    cpu = serve_drive(torch.device("cpu"), SERVE_CPU_SESSIONS, bad)
    cpu.pop("_offered")
    out["cpu"] = cpu
    out["card_over_cpu_asks_per_s"] = (card["agg_asks_per_s"]
                                       / cpu["agg_asks_per_s"])

    # `ut-torch serve` as a process: its port from the log, one ask /
    # tell over TCP, SIGTERM, exit code 0
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "uptune_tpu_torch.cli", "serve", "--port",
         "0", "--store-dir", "off"], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cli = {"rc": None}
    try:
        port, log = None, []
        while port is None:
            line = proc.stdout.readline()
            if not line:
                break
            log.append(line)
            if "listening on" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
        cli["start_s"] = time.perf_counter() - t0
        if port is None:
            bad.append("ut-torch serve did not listen: " + "".join(log))
        else:
            with connect(("127.0.0.1", port)) as c:
                with c.open_session(rosenbrock_space(4, -3.0, 3.0),
                                    seed=1, store=False) as h:
                    trials = h.ask(4)
                    r = h.tell_many([(t.ticket, 1.0 + i)
                                     for i, t in enumerate(trials)])
                    cli["told"] = r["told"]
                    cli["best_qor"] = h.best()["qor"]
            proc.send_signal(signal.SIGTERM)
            cli["rc"] = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out["cli"] = cli
    if cli["rc"] != 0 or cli.get("told") != 4 or cli.get("best_qor") != 1.0:
        bad.append(f"ut-torch serve subprocess: {cli}")
    emit(out)
    if bad:
        raise AssertionError("serve: " + "; ".join(bad))
    return out


# -- the sharded front tier -------------------------------------------------------
# the port's kernel functions as a CUDA trace names them
PORT_KERNEL_FN = re.compile(
    r"\b(merge_rows_kernel|kinv_prep_kernel|krows_kernel|krows_mma_kernel|"
    r"wq_kernel|moments_kernel|final_kernel|topk_merge_kernel|"
    r"gp_mean_kernel)\b")


def trace_kernels(path) -> dict:
    """The CUDA kernel events of one torch.profiler Chrome trace
    (`all`) and, by function, those of the port's kernels; None when the
    trace is missing or unreadable."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    out = {"all": 0}
    for e in doc.get("traceEvents", ()):
        if e.get("cat") != "kernel":
            continue
        out["all"] += 1
        m = PORT_KERNEL_FN.search(str(e.get("name", "")))
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of a live process (/proc/<pid>/stat)."""
    import os
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def rosenbrock_qor(cfg: dict, dims: int) -> float:
    x = [cfg[f"x{i}"] for i in range(dims)]
    return float(sum(100.0 * (x[i + 1] - x[i] ** 2) ** 2 + (1 - x[i]) ** 2
                     for i in range(dims - 1)))


def fleet_timeline(path) -> tuple:
    """A router's fleet timeline (`Router(hub_timeline=)`, every row its
    hub acked): each source's last window, by pid, and the fleet's
    counters as a hub that replays the timeline serves them."""
    from uptune_tpu_torch.obs import flight
    from uptune_tpu_torch.obs.hub import TelemetryHub
    last = {}
    for row in flight.read_chain(str(path)):
        if row.get("kind") == "window" and isinstance(row.get("row"), dict):
            last[row["src"].split(":")[1]] = row["row"]
    hub = TelemetryHub(port=0, timeline=str(path))
    try:
        fleet = hub.handle({"op": "metrics"})["metrics"]["counters"]
    finally:
        hub.stop()
    return last, fleet


def cold_starts(rows: list, t_ready: float) -> list:
    """The seconds each shard of a tier that `Router.start()` booted one
    after another took to answer its ping, from the router's `shards`
    rows read at once: a shard's spawn follows the last one's ping, and
    `t_ready` (time.time()) is when start() returned."""
    now = time.time()
    born = sorted(now - row["uptime_s"] for row in rows)
    return [b - a for a, b in zip(born, born[1:] + [t_ready])]


def route_placement(n_spaces: int, dims: int, k: int, s0_partial: bool):
    """Space signatures for a routed drive, by the JAX package's idiom
    (`bench.py:3063-3082`): rosenbrock over [-3 - i - o/8, 3 + i + o/8],
    the offset o walked until every shard s0..s{k-1} owns a signature
    (and, with s0_partial, s0 owns some but not all of them)."""
    from uptune_tpu_torch.exec.space_io import records_from_space
    from uptune_tpu_torch.serve.router import HashRing, routing_key
    from uptune_tpu_torch.workloads import rosenbrock_space
    ring = HashRing()
    for i in range(k):
        ring.add(f"s{i}")
    for o in range(64):
        bounds = [(-3.0 - i - o * 0.125, 3.0 + i + o * 0.125)
                  for i in range(n_spaces)]
        records = [records_from_space(rosenbrock_space(dims, lo, hi))
                   for lo, hi in bounds]
        owners = [ring.lookup(routing_key(r)) for r in records]
        if len(set(owners)) == k and (
                not s0_partial or 1 <= owners.count("s0") < n_spaces):
            return {"offset_steps": o, "bounds": bounds, "records": records,
                    "owners": owners}
    raise AssertionError(f"no placement of {n_spaces} spaces over {k} "
                         f"shards")


def route_sharded(dev, work: Path, bad: list) -> dict:
    """Part (a) of the route phase: the JAX package's sharded protocol
    (`bench.py --serve-sharded`, not --quick) on the port (see the
    module docstring)."""
    import os
    from uptune_tpu_torch.obs import faults
    from uptune_tpu_torch.serve import LocalSession, connect
    from uptune_tpu_torch.serve.router import Router
    from uptune_tpu_torch.workloads import rosenbrock_space
    place = route_placement(ROUTE_SPACES, 2, ROUTE_K[-1], True)
    records, owners = place["records"], place["owners"]
    work.mkdir(parents=True, exist_ok=True)
    out = {"placement": {k: place[k] for k in ("owners", "offset_steps")}}
    per, errors, lock = {}, [], threading.Lock()

    def drive(router, idx, seed, tag, n_epochs, hold, held):
        # one auto-resume client driving one session to n_epochs committed
        # versions through the router (open redirected to the owning
        # shard, everything after shard-direct); with `hold`, a session
        # placed on a shard in `held` pauses after its first committed
        # epoch until `hold` is set (the kill has fired, the fleet has
        # been scraped)
        try:
            c = connect(("127.0.0.1", router.port), timeout=120,
                        auto_resume=True, max_retries=80, backoff_base=0.25,
                        backoff_max=2.0)
            h = c.open_session(records[idx], seed=seed,
                               program=f"sharded-{idx}")
            memo, asks, acked, monotone = {}, 0, 0, True
            stop_at = time.time() + 300
            while h.version < n_epochs:
                if time.time() > stop_at:
                    raise RuntimeError(f"{tag}/{idx} wedged at v{h.version}")
                if hold is not None and owners[idx] in held and h.version:
                    hold.wait(timeout=120)
                trials = h.ask(ROUTE_CHUNK)
                if not trials:
                    continue
                asks += len(trials)
                res = []
                for t in trials:
                    key = json.dumps(t.config, sort_keys=True)
                    if key not in memo:
                        memo[key] = rosenbrock_qor(t.config, 2)
                    res.append((t.ticket, memo[key]))
                r = h.tell_many(res)
                # zero committed loss, client-observed: an acked committed
                # version never goes back after a resume
                v = r.get("version")
                if v is not None:
                    monotone &= int(v) >= acked
                    if r.get("committed"):
                        acked = max(acked, int(v))
            with lock:
                per[tag, idx] = {"best": h.best(), "asks": asks,
                                 "acked": acked, "monotone": monotone,
                                 "reconnects": c.reconnects,
                                 "redirects": c.redirects}
            h.close()
            c.close()
        except Exception as e:
            with lock:
                errors.append((tag, idx, repr(e)))

    def run_round(router, tag, seed_base, n_epochs, mid=None, hold=None,
                  held=("s0",)):
        ts = [threading.Thread(target=drive, args=(
            router, i, seed_base + i, tag, n_epochs, hold, held))
            for i in range(ROUTE_SPACES)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        if mid is not None:
            mid()
        for t in ts:
            t.join(600)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in ts):
            raise AssertionError(f"route round {tag}: {errors}")
        asks = sum(per[tag, i]["asks"] for i in range(ROUTE_SPACES))
        return {"asks": asks, "wall_s": wall, "agg_asks_per_s": asks / wall}

    def router(name, shards):
        return Router(port=0, shards=shards, slots=4,
                      max_sessions=ROUTE_SPACES * 2 + 8,
                      store_dir=str(work / "store"), work_dir=str(work / name),
                      supervise_interval=0.5, device=str(dev),
                      hub_timeline=str(work / f"{name}.fleet.jsonl"))

    # the scaling run, its shards traced: K walked by the scale op, one
    # round of every session at each K; then a short round at K 3 whose
    # sessions hold after their first epoch while the fleet is scraped
    trace_dir = work / "device_trace"
    ra = router("scaling", 0)
    fleet, scaling = {}, {}
    scraped = threading.Event()

    def scrape_mid():
        # every shard has said hello to the hub and shipped a window
        # with the live sessions, then the scrape ops and `top` itself
        deadline, m = time.time() + 60, {}
        while time.time() < deadline:
            m = ra.handle({"op": "metrics"})
            if m.get("sessions") and m.get("sources") == ROUTE_K[-1]:
                break
            time.sleep(0.25)
        src = ra.handle({"op": "sources"})
        r = subprocess.run(
            [sys.executable, "-m", "uptune_tpu_torch.cli", "top", "--addr",
             f"127.0.0.1:{ra.port}", "--once", "--fleet", "--json"],
            env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
            text=True, timeout=120)
        try:
            frame = json.loads(r.stdout)
        except ValueError:
            frame = {}
        fleet.update(
            metrics={k: m.get(k) for k in ("sessions", "shards", "sources")},
            sources=[{k: row.get(k) for k in ("shard", "pid", "final",
                                               "stale", "rates")}
                     for row in src.get("rows", ())],
            top_rc=r.returncode,
            top_sources=len(frame.get("sources") or ()),
            top_meta_sources=(frame.get("meta") or {}).get("sources"),
            top_counters={k: v for k, v in (frame.get("counters") or {})
                          .items() if k.startswith("serve.")})
        if not (r.returncode == 0 and fleet["top_sources"] == ROUTE_K[-1]
                and fleet["top_meta_sources"] == ROUTE_K[-1]):
            bad.append(f"route: top --addr <router> --fleet: {fleet} "
                       f"{r.stderr[-2000:]}")
        scraped.set()

    os.environ["UT_DEVICE_TRACE"] = str(trace_dir)      # this run's shards
    try:
        ra.start()
        for ki, k in enumerate(ROUTE_K):
            t0 = time.perf_counter()
            r = ra.handle({"op": "scale", "shards": k})
            scale_s = time.perf_counter() - t0
            if not (r["ok"] and r["live"] == k):
                raise AssertionError(f"route: scale to {k}: {r}")
            if k == ROUTE_K[-1]:
                os.environ.pop("UT_DEVICE_TRACE")
            scaling[str(k)] = dict(run_round(
                ra, f"k{k}", 5000 + 1000 * ki, ROUTE_EPOCHS),
                scale_s=scale_s)
        run_round(ra, "scrape", 7000, 2, mid=scrape_mid, hold=scraped,
                  held=tuple(f"s{i}" for i in range(ROUTE_K[-1])))
        stats_a = ra.handle({"op": "stats"})
    finally:
        os.environ.pop("UT_DEVICE_TRACE", None)
        t0 = time.perf_counter()
        ra.stop()                           # SIGTERM: traces, final windows
        stop_s = time.perf_counter() - t0
    out["scaling"] = scaling
    out["fleet_scrape_mid_drive"] = fleet
    # each traced shard: its merge launches against its own commits (its
    # final window, as the hub acked it), and no other kernel of the port;
    # a shard killed at the end of the stop's grace, its trace not yet
    # written out, leaves no trace or a torn one and fails here
    last, _ = fleet_timeline(work / "scaling.fleet.jsonl")
    shards, merges, gp_events = {}, 0, 0
    for sh in stats_a["shards"]:
        win = last.get(str(sh["pid"])) or {}
        kern = trace_kernels(trace_dir / sh["name"] / "device_trace.json")
        row = {"pid": sh["pid"], "restarts": sh["restarts"],
               "final_window": bool(win.get("final")),
               "commits": (win.get("counters") or {}).get("serve.commits"),
               "trace": kern}
        shards[sh["name"]] = row
        if kern is None:
            bad.append(f"route: shard {sh['name']} left no device trace: "
                       f"{row}")
            continue
        merges += kern.get("merge_rows_kernel", 0)
        others = {k: v for k, v in kern.items()
                  if k not in ("all", "merge_rows_kernel")}
        gp_events += sum(others.values())
        if not (row["final_window"] and row["commits"]
                and kern.get("merge_rows_kernel") == row["commits"]
                and not others and not row["restarts"]):
            bad.append(f"route: shard {sh['name']}: {row}")
    out["traced_shards"] = shards
    out["merge_launches"], out["gp_kernel_events"] = merges, gp_events
    out["stop_s"] = stop_s
    if len(shards) != ROUTE_K[-1] or stats_a["kills"] or stats_a["restarts"]:
        bad.append(f"route: scaling run shards {sorted(shards)}, stats "
                   f"{stats_a}")

    # the kill: a fresh tier of K shards, untraced; every session commits,
    # route.kill SIGKILLs s0 on one supervisor tick, the supervisor
    # respawns it on its port with its checkpoints, the clients resume
    rb = router("kill", ROUTE_K[-1])
    epochs_kill = ROUTE_EPOCHS + 2
    kill_seen = threading.Event()
    try:
        t0 = time.perf_counter()
        rb.start()
        out["kill_tier_start_s"] = time.perf_counter() - t0

        def mid():
            deadline = time.time() + 300
            while (time.time() < deadline and rb.handle({"op": "ping"})[
                    "sessions"] < ROUTE_SPACES):
                time.sleep(0.1)
            faults.arm("route.kill", "error",
                       at=faults.hits("route.kill") + 1)
            deadline = time.time() + 60
            while time.time() < deadline and rb.kills < 1:
                time.sleep(0.1)
            kill_seen.set()

        out["kill_round"] = run_round(rb, "kill", 6000, epochs_kill,
                                      mid=mid, hold=kill_seen)
        faults.disarm()
        stats = rb.handle({"op": "stats"})
    finally:
        faults.disarm()
        rb.stop()
    restarts = {row["name"]: row["restarts"] for row in stats["shards"]}
    affected = [i for i in range(ROUTE_SPACES) if owners[i] == "s0"]
    parity = []
    for i in range(ROUTE_SPACES):
        # the uninterrupted matched-seed run on the card
        lo, hi = place["bounds"][i]
        ls = LocalSession(rosenbrock_space(2, lo, hi), seed=6000 + i,
                          device=dev)
        while ls.version < epochs_kill:
            for t in ls.ask(ROUTE_CHUNK):
                ls.tell(t.ticket, rosenbrock_qor(t.config, 2))
        want = ls.best()
        ls.close()
        got = per["kill", i]
        parity.append({"space": i, "owner": owners[i],
                       "config_equal": got["best"]["config"] == want["config"],
                       "qor_equal": got["best"]["qor"] == want["qor"],
                       "version_equal": got["best"]["version"]
                       == want["version"] == epochs_kill,
                       "monotone": got["monotone"],
                       "no_acked_loss": got["best"]["version"] >= got["acked"],
                       "reconnects": got["reconnects"],
                       "redirects": got["redirects"]})
    out["kill"] = {"epochs": epochs_kill, "kills": stats["kills"],
                   "restarts": restarts, "victim": "s0",
                   "affected_sessions": affected, "parity": parity}
    ok = (stats["kills"] == 1
          and restarts == {f"s{i}": int(i == 0) for i in range(ROUTE_K[-1])}
          and affected
          and all(p["config_equal"] and p["qor_equal"] and p["version_equal"]
                  and p["monotone"] and p["no_acked_loss"] for p in parity)
          and all(parity[i]["reconnects"] > 0 for i in affected))
    out["kill"]["ok"] = ok
    if not ok:
        bad.append(f"route: the kill: {out['kill']}")
    return out


def route_loaded(dev, work: Path, bad: list, serve) -> dict:
    """Part (b) of the route phase: the serve phase's protocol over K
    shard processes whose groups live on `dev` (see the module
    docstring)."""
    import os
    import numpy as np
    from uptune_tpu_torch.serve import connect
    from uptune_tpu_torch.serve.router import Router
    dims, ask_n, hist = 4, 8, 256
    place = route_placement(ROUTE_SIGS, dims, ROUTE_SHARDS, False)
    records = place["records"]
    per_sig = ROUTE_TENANTS // ROUTE_SIGS
    work.mkdir(parents=True, exist_ok=True)
    timeline = work / "fleet.jsonl"
    r = Router(port=0, shards=ROUTE_SHARDS, slots=per_sig,
               max_sessions=ROUTE_TENANTS + 64, store_dir=str(work / "store"),
               work_dir=str(work), device=str(dev),
               hub_timeline=str(timeline))
    out = {"sessions": ROUTE_TENANTS, "signatures": ROUTE_SIGS,
           "shards": ROUTE_SHARDS, "waves": ROUTE_WAVES,
           "owners": place["owners"], "offset_steps": place["offset_steps"]}
    n_threads = ROUTE_SIGS                   # one a signature
    clients, handles = [None] * n_threads, [None] * n_threads
    errors, lat_lock = [], threading.Lock()

    def measure_all(cfgs):
        x = np.array([[c[f"x{i}"] for i in range(dims)] for c in cfgs])
        return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                + (1 - x[:, :-1]) ** 2).sum(axis=1).tolist()

    def drive(hs, lats):
        n_asks = 0
        for h in hs:
            done = False
            while not done:
                a = time.perf_counter()
                trials = h.ask(ask_n)
                lats.append(time.perf_counter() - a)
                if not trials:
                    done = True
                    continue
                n_asks += len(trials)
                res = h.tell_many(zip((t.ticket for t in trials),
                                      measure_all([t.config for t in trials])))
                done = bool(res.get("committed"))
        return n_asks

    t_start = time.perf_counter()
    try:
        r.start()
        t_ready = time.time()
        out["start_s"] = time.perf_counter() - t_start
        tier = r.handle({"op": "shards"})["shards"]
        out["shard_cold_start_s"] = cold_starts(tier, t_ready)
        addrs = {row["name"]: row["addr"] for row in tier}
        pids = {row["name"]: row["pid"] for row in tier}

        def open_all(ti):
            try:
                c = connect(("127.0.0.1", r.port))
                hs = [c.open_session(records[ti], seed=ti * 10000 + j,
                                     program="chip-route",
                                     history_capacity=hist)
                      for j in range(per_sig)]
                clients[ti], handles[ti] = c, hs
            except Exception as e:
                errors.append(repr(e))

        t0 = time.perf_counter()
        ts = [threading.Thread(target=open_all, args=(ti,))
              for ti in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        out["open_s"] = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"route: opens: {errors}")
        # the probe: one session's epoch alone, its first ask the first
        # trial after Router.start()
        probe_lat = []
        drive([handles[0][0]], probe_lat)
        out["first_trial_from_start_s"] = (t0 - t_start + out["open_s"]
                                           + probe_lat[0])
        out["first_ask_ms"] = probe_lat[0] * 1e3
        cpu0 = {n: proc_cpu_s(p) for n, p in pids.items()}
        lats, totals, walls = [], [], []
        done_s = [0.0] * n_threads          # a signature's threads' drive
        barrier = threading.Barrier(n_threads)

        def run_waves(ti):
            try:
                for _ in range(ROUTE_WAVES):
                    barrier.wait()
                    a = time.perf_counter()
                    mine = []
                    n = drive(handles[ti], mine)
                    done_s[ti] += time.perf_counter() - a
                    with lat_lock:
                        lats.extend(mine)
                        totals.append(n)
                    barrier.wait()
                    if ti == 0:
                        walls.append(time.perf_counter() - a)
            except BaseException as exc:
                errors.append(repr(exc))
                barrier.abort()
                raise

        me0 = time.process_time()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=run_waves, args=(ti,))
              for ti in range(n_threads)]
        with GpuBusy() as busy:
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        drive_s = time.perf_counter() - t0
        client_cpu = time.process_time() - me0
        shard_cpu = {n: proc_cpu_s(p) - cpu0[n] for n, p in pids.items()}
        if errors:
            raise AssertionError(f"route: waves: {errors}")
        versions = [h.version for hs in handles for h in hs]
        # each shard's own counters, scraped from the shard itself
        own = {}
        for name, addr in sorted(addrs.items()):
            host, port = addr.rsplit(":", 1)
            with connect((host, int(port)), timeout=30) as sc:
                m = sc.metrics()
            c = (m.get("metrics") or {}).get("counters") or {}
            h = (m.get("metrics") or {}).get("hists") or {}
            own[name] = {k: c.get(f"serve.{k}") for k in (
                "commits", "proposes", "asks", "tells", "store_served")}
            own[name]["server_hists"] = serve_hists(h)
            own[name]["sessions"] = m.get("sessions")
            # when the last of its signatures' threads finished its waves
            own[name]["signatures_done_s"] = max(
                done_s[i] for i, o in enumerate(place["owners"])
                if o == name)
        for ti in range(n_threads):
            c, hs = clients[ti], handles[ti]
            c.batch([{"op": "close", "session": h.id} for h in hs])
            c.close()
    finally:
        r.stop()                            # SIGTERM: the final windows
    last, fleet = fleet_timeline(timeline)
    rollup = {}
    for name, pid in sorted(pids.items()):
        win = last.get(str(pid)) or {}
        c = win.get("counters") or {}
        rollup[name] = {"commits": c.get("serve.commits"),
                        "proposes": c.get("serve.proposes"),
                        "final": bool(win.get("final"))}
    total = sum(totals)
    ms = np.sort(np.array(lats)) * 1e3
    out.update({
        "drive_s": drive_s, "asks": total, "agg_asks_per_s": total / drive_s,
        "wave_walls_s": walls,
        "ask": {"requests": len(ms), "p50_ms": float(ms[len(ms) // 2]),
                "p95_ms": float(ms[int(len(ms) * 0.95)]),
                "max_ms": float(ms[-1])},
        "shards_own": own, "shards_rollup": rollup,
        "fleet_commits": fleet.get("serve.commits"),
        "fleet_proposes": fleet.get("serve.proposes"),
        "shard_cpu_over_wall": {n: v / drive_s for n, v in shard_cpu.items()},
        "gpu_busy": busy.summary(),
        "client_cpu_over_wall": client_cpu / drive_s})
    if serve is not None:
        out["single_server_asks_per_s"] = serve["card"]["agg_asks_per_s"]
        out["routed_over_single"] = (out["agg_asks_per_s"]
                                     / out["single_server_asks_per_s"])
    own_commits = sum(v["commits"] or 0 for v in own.values())
    want = ROUTE_TENANTS * ROUTE_WAVES + 1          # the probe's epoch too
    ok = (min(versions) >= ROUTE_WAVES and own_commits == want
          and out["fleet_commits"] == own_commits
          and all(v["final"] for v in rollup.values())
          and all(v["commits"] == own[n]["commits"]
                  for n, v in rollup.items())
          and all(own[n]["commits"] for n in own))
    out["ok"] = ok
    if not ok:
        bad.append(f"route: the loaded drive: versions {min(versions)}, "
                   f"own {own}, rollup {rollup}, fleet {out['fleet_commits']}"
                   f", want {want}")
    return out


def route_phase(dev, serve=None) -> dict:
    """The sharded front tier on the card (see the module docstring):
    part (a), the JAX package's sharded protocol with the traced scaling
    run and the kill, and part (b), the loaded routed drive; with the
    serve phase's result, routed asks/s over the single server's."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    out = {"phase": "route"}
    bad = []
    tmp = Path(tempfile.mkdtemp(prefix="ut_route_"))
    try:
        out["sharded"] = route_sharded(dev, tmp / "sharded", bad)
        out["loaded"] = route_loaded(dev, tmp / "loaded", bad, serve)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("route: " + "; ".join(bad))
    return out


# -- the cooperative store ----------------------------------------------------------
# the JAX package's `bench.py --store-remote` protocol (not --quick)
STORE_K = 3
STORE_DIMS, STORE_LO, STORE_HI = 4, -6, 6
STORE_BUDGET, STORE_TARGET = 300, 3.0
STORE_SEEDS = tuple(9100 + i for i in range(STORE_K))
STORE_EXCHANGE_S = 0.02
STORE_CRASH_AT = 25
STORE_SURROGATE = {"min_points": 12, "refit_interval": 16,
                   "max_points": 192, "async_refit": False}


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def store_child_main(argv) -> int:
    """`chip_smoke.py --store-child`: one tuning process of the store
    phase, on the card — a journaled `Tuner(surrogate="gp")` over the
    integer rosenbrock whose loop is the controller's store discipline
    (lookup before measuring, record after, exchange and federate on the
    refresh tick), pointed at a `ut-torch store` server (--addr
    tcp://...) or at nothing (--addr off: the independent matched-seed
    replica).  Its commits are counted around `Tuner._commit`, its merge
    launches by the wrapper, and UT_DEVICE_TRACE captures its kernels.
    Prints one JSON line."""
    t_start = time.time()
    ap = argparse.ArgumentParser()
    ap.add_argument("--store-child", action="store_true")
    ap.add_argument("--addr", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--journal", required=True)
    ap.add_argument("--tag", required=True)
    args = ap.parse_args(argv)
    import collections
    import numpy as np
    from uptune_tpu_torch import native, obs
    from uptune_tpu_torch.driver import Tuner
    from uptune_tpu_torch.store.remote import RemoteStore
    from uptune_tpu_torch.workloads import rosenbrock_space
    t_imported = time.time()
    dims = STORE_DIMS
    space = rosenbrock_space(dims, STORE_LO, STORE_HI, as_int=True)

    def measure(cfg):
        x = np.array([float(cfg[f"x{i}"]) for i in range(dims)])
        return float(np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                            + (1 - x[:-1]) ** 2))

    store = None
    if args.addr != "off":
        store = RemoteStore(args.addr, [repr(s) for s in space.specs],
                            "chip-smoke-store",
                            refresh_interval=STORE_EXCHANGE_S)
    t_trace = time.time()
    obs.device.maybe_trace_from_env()
    t_traced = time.time()
    obs.enable(capacity=1 << 18)
    jmon = obs.start_journal(args.journal, meta={
        "example": "chip_smoke.py store", "tag": args.tag,
        "seed": args.seed, "addr": args.addr,
        "workload": f"rosenbrock-{dims}d-int"})
    tuner = Tuner(space, None, seed=args.seed, surrogate="gp",
                  surrogate_opts=dict(STORE_SURROGATE), device="cuda")
    commits = [0]
    commit = tuner._commit

    def counted(*a, **kw):
        commits[0] += 1
        return commit(*a, **kw)
    tuner._commit = counted
    native.reset_launches()
    t_ready = time.time()
    evals, best, hit_at = 0, float("inf"), None
    exchange_injected = federated = 0
    queue: collections.deque = collections.deque()

    def serve(tr):
        nonlocal evals, best
        row = store.lookup(tr.config) if store is not None else None
        if row is not None:
            q = float(row["qor"])
            tuner.tell(tr, q, float(row.get("dur", 0.0)))
            obs.journal.emit("store_hit", gid=tr.gid, qor=round(q, 6))
        else:
            q = measure(tr.config)
            evals += 1
            tuner.tell(tr, q)
            if store is not None:
                tk = tr.ticket
                store.record(tr.config, q, u=tk.u_np[tr.slot],
                             perms=[pp[tr.slot] for pp in tk.perms_np])
        best = min(best, q)

    while evals < STORE_BUDGET and not (hit_at is not None and not queue):
        if not queue:
            queue.extend(tuner.ask(min_trials=1))
        serve(queue.popleft())
        if hit_at is None and best <= STORE_TARGET:
            hit_at = evals
        if store is not None and store.maybe_refresh():
            rows = store.pop_fresh_rows()
            if rows:
                # elite migration + federated surrogate rows: the
                # controller's _maybe_exchange_best split
                top = min(rows, key=lambda r: float(r["qor"]))
                injected = []
                if tuner.sign * float(top["qor"]) < float(tuner.best.qor):
                    injected = tuner.inject([top["cfg"]], source="exchange")
                if injected:
                    exchange_injected += len(injected)
                    obs.journal.emit("exchange",
                                     qor=round(float(top["qor"]), 6))
                    queue.extendleft(reversed(injected))
                rest = [r for r in rows if not (injected and r is top)]
                n = tuner.preload_rows(rest, refit=False)
                if n:
                    federated += n
                    if tuner.surrogate is not None:
                        tuner.surrogate.maybe_refit()
                    obs.journal.emit("federate", rows=n)
    torch.cuda.synchronize()
    t_done = time.time()
    res = tuner.result()
    launches = kernel_launches()
    tuner.close()
    obs.journal.flush()
    obs.stop_journal(jmon)
    gauges = dict(jmon.gauges)
    t_export = time.time()
    obs.device.stop_trace()
    t_exported = time.time()
    sstats = store.stats() if store is not None else None
    if store is not None:
        store.flush_wait(10.0)
        store.close()
    print(json.dumps({
        "tag": args.tag, "seed": args.seed, "evals": evals,
        "hit_at": hit_at, "best": round(best, 6),
        "tuner_best": round(res.best_qor, 6),
        "exchange_injected": exchange_injected, "federated": federated,
        "commits": commits[0], "launches": launches,
        "t_start": t_start, "t_ready": t_ready,
        "import_s": t_imported - t_start,
        "trace_start_s": t_traced - t_trace,
        "trace_export_s": t_exported - t_export,
        "tune_s": t_done - t_ready, "store": sstats,
        "gauges": gauges}), flush=True)
    return 0


def store_phase(dev) -> dict:
    """The cooperative store on the card (see the module docstring):
    K cooperating children against K independent ones, each journal
    replayed, each child's merge launches from its wrapper (and, in the
    cooperating fleet, from its own device trace); then the
    deterministic mid-append kill."""
    import os
    import shutil
    import subprocess
    import tempfile
    from uptune_tpu_torch import obs
    from uptune_tpu_torch.store.remote import RemoteStore
    t_phase = time.perf_counter()
    out = {"phase": "store", "k": STORE_K, "dims": STORE_DIMS,
           "lo": STORE_LO, "hi": STORE_HI, "budget": STORE_BUDGET,
           "target": STORE_TARGET, "seeds": list(STORE_SEEDS),
           "exchange_interval_s": STORE_EXCHANGE_S}
    bad = []
    work = Path(tempfile.mkdtemp(prefix="ut_store_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def wait_ready(port, child, what, deadline_s=60):
        import socket
        deadline = time.time() + deadline_s
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=2).close()
                return
            except OSError:
                if child.poll() is not None:
                    raise RuntimeError(f"{what} died before ready: "
                                       + child.communicate()[0][-2000:])
                time.sleep(0.05)
        raise RuntimeError(f"{what} never came up")

    def start_server(port, root, extra=None):
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-m", "uptune_tpu_torch.cli", "store",
             "--port", str(port), "--dir", str(root)], cwd=str(work),
            env=dict(env, **(extra or {})), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        wait_ready(port, child, "ut-torch store")
        return child, time.perf_counter() - t0

    def req(port, payload):
        import socket
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            f = s.makefile("rwb")
            f.write(json.dumps(payload).encode() + b"\n")
            f.flush()
            resp = json.loads(f.readline())
        if not resp.get("ok"):
            raise RuntimeError(f"store request {payload}: {resp}")
        return resp

    def run_fleet(label, addr, traced):
        # the K children at once, each in its own CUDA context and, in a
        # traced fleet, traced into its own directory (the profiler's
        # start takes ~8 s a child: the independent fleet goes untraced
        # for the run's time limit, its merge launches held by the
        # wrapper's count alone)
        children, outs = [], []
        for i, seed in enumerate(STORE_SEEDS):
            tag = f"{label}-{i}"
            jpath = work / f"journal_{tag}.jsonl"
            t_spawn = time.time()
            ch = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--store-child",
                 "--addr", addr, "--seed", str(seed), "--journal",
                 str(jpath), "--tag", tag], cwd=str(work),
                env=dict(env, **({"UT_DEVICE_TRACE": str(
                    work / "trace" / tag)} if traced else {})),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            children.append((tag, jpath, t_spawn, ch))
        for tag, jpath, t_spawn, ch in children:
            try:
                txt = ch.communicate(timeout=600)[0]
            except subprocess.TimeoutExpired:
                for *_, c in children:
                    c.kill()
                raise
            if ch.returncode != 0:
                raise RuntimeError(f"{tag} failed (rc={ch.returncode}): "
                                   f"{txt[-3000:]}")
            o = json.loads([ln for ln in txt.strip().splitlines()
                            if ln.startswith("{")][-1])
            o["cold_start_s"] = o["t_ready"] - t_spawn
            o["traced"] = traced
            o["trace"] = (trace_kernels(work / "trace" / tag
                                        / "device_trace.json")
                          if traced else None)
            outs.append((jpath, o))
        return outs

    server = None
    try:
        # ---- K cooperating children against K independent ones -----------
        port = free_port()
        server, out["server_start_s"] = start_server(port, work / "store")
        t0 = time.perf_counter()
        try:
            coop = run_fleet("coop", f"tcp://127.0.0.1:{port}", True)
        finally:
            server.terminate()
            server.wait(timeout=30)
            server = None
        out["coop_fleet_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        indep = run_fleet("indep", "off", False)
        out["indep_fleet_s"] = time.perf_counter() - t0

        replay_exact = True
        children = {}
        for jpath, o in coop + indep:
            _, rows = obs.journal.read(str(jpath), strict=True)
            replayed = obs.quality.replay(rows)
            exact = o["gauges"] == replayed.gauges
            replay_exact &= exact
            tr = o["trace"] or {}
            merge_trace = tr.get("merge_rows_kernel")
            others = {k: v for k, v in tr.items()
                      if k not in ("all", "merge_rows_kernel")}
            want = {k: 0 for k in o["launches"]}
            want["merge_rows"] = o["commits"]
            children[o["tag"]] = {
                "evals": o["evals"], "hit_at": o["hit_at"],
                "best": o["best"], "commits": o["commits"],
                "merge_launches": o["launches"]["merge_rows"],
                "merge_launches_traced": merge_trace,
                "other_port_kernels_traced": others,
                "cold_start_s": o["cold_start_s"], "import_s": o["import_s"],
                "trace_start_s": o["trace_start_s"], "tune_s": o["tune_s"],
                "trace_export_s": o["trace_export_s"],
                "exchange_injected": o["exchange_injected"],
                "federated": o["federated"], "journal_replay_exact": exact,
                "store_hits": (o["store"] or {}).get("hits")}
            if o["launches"] != want or others or not o["commits"] \
                    or (o["traced"] and merge_trace != o["commits"]):
                bad.append(f"{o['tag']}: launches {o['launches']}, traced "
                           f"merge {merge_trace}, other kernels {others}, "
                           f"commits {o['commits']}")
            if not exact:
                bad.append(f"{o['tag']}: online gauges differ from the "
                           f"journal's replay")

        def hit(o):
            return o["hit_at"] if o["hit_at"] is not None \
                else STORE_BUDGET + 1
        coop_hits = [hit(o) for _, o in coop]
        indep_hits = [hit(o) for _, o in indep]
        out.update(
            children=children, coop_evals_to_target=coop_hits,
            indep_evals_to_target=indep_hits, coop_min=min(coop_hits),
            indep_min=min(indep_hits),
            exchange_injected=sum(o["exchange_injected"] for _, o in coop),
            federated_rows=sum(o["federated"] for _, o in coop),
            journal_replay_exact=replay_exact)
        if not out["exchange_injected"] or not out["federated_rows"]:
            bad.append("the cooperating children exchanged nothing")

        # ---- the deterministic mid-append kill -------------------------------
        port2 = free_port()
        root2 = work / "store_crash"
        server, _ = start_server(port2, root2, {
            "UT_FAULTS": f"rstore.append=crash@{STORE_CRASH_AT}"})
        sig = ["chip-smoke-crash-spec"]
        clients = [RemoteStore(f"tcp://127.0.0.1:{port2}", sig,
                               "chip-smoke-crash", refresh_interval=3600.0,
                               backoff_base=0.05, backoff_max=0.5)
                   for _ in range(STORE_K)]
        rec_keys = [[] for _ in range(STORE_K)]
        stop_rec = threading.Event()

        def writer(ci):
            n = 0
            while not stop_rec.is_set() and n < 200:
                row = clients[ci].record({"c": ci, "i": n}, float(n + 1),
                                         source=f"w{ci}")
                if row is not None:
                    rec_keys[ci].append(row["k"])
                n += 1
                time.sleep(0.005)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(STORE_K)]
        for t in threads:
            t.start()
        server.wait(timeout=120)
        crash_rc = server.returncode
        server = None
        t0 = time.perf_counter()
        clients[0].record({"deg": "probe"}, 999.0)
        degrade_ms = (time.perf_counter() - t0) * 1e3
        stop_rec.set()
        for t in threads:
            t.join()
        acked = [c.stats()["remote"]["acked"] for c in clients]
        acked_keys = [ks[:a] for ks, a in zip(rec_keys, acked)]
        for c in clients[1:]:
            c.close()
        server, restart_s = start_server(port2, root2)
        try:
            lost = [k for ks in acked_keys for k in ks
                    if req(port2, {"op": "lookup", "k": k}).get("row")
                    is None]
            st = req(port2, {"op": "stats"})
            drained = clients[0].flush_wait(30.0)
            resumed = clients[0].connected
            survivor_ok = all(
                req(port2, {"op": "lookup", "k": k}).get("row") is not None
                for k in rec_keys[0])
            dropped = clients[0].stats()["remote"]["dropped"]
        finally:
            clients[0].close()
        out["kill"] = {
            "crash_at_append": STORE_CRASH_AT, "crash_rc": crash_rc,
            "acked_before_kill": acked, "acked_rows_lost": len(lost),
            "rows_after_restart": st["rows"], "replayed": st["replayed"],
            "torn_tail": st["torn_tail"], "restart_s": restart_s,
            "degraded_record_ms": degrade_ms, "survivor_drained": drained,
            "survivor_resumed": resumed,
            "survivor_all_rows_on_server": survivor_ok,
            "survivor_dropped": dropped}
        if not (crash_rc == 137 and not lost and sum(acked) > 0 and drained
                and resumed and survivor_ok and dropped == 0
                and degrade_ms < 100.0):
            bad.append(f"the kill: {out['kill']}")
    finally:
        if server is not None:
            server.terminate()
            server.wait(timeout=30)
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("store: " + "; ".join(bad))
    return out


# -- the mesh plane -----------------------------------------------------------------
PAR_STEPS = 50
PAR_BF_STEPS = 5


def sharded_run(eng, mesh, seed: int, steps: int) -> tuple:
    """(state, seconds, merge launches) of a ShardedEngine run."""
    from uptune_tpu_torch import native
    from uptune_tpu_torch.parallel import ShardedEngine
    se = ShardedEngine(eng, mesh)
    st0 = se.init(seed)
    se.run(st0, 1)                                # warm step
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    st = se.run(st0, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return se, st, wall, kernel_launches()


def mesh_rank_main() -> int:
    """`chip_smoke.py --mesh-rank`: one rank of the parallel phase's
    process group — `initialize()` from the UT_* environment
    (`ut-torch --num-hosts`'s), the multi-process mesh on the one card,
    and the flagship's ShardedEngine (search 2, eval 1) over gloo.
    Prints one JSON line."""
    from uptune_tpu_torch.flagship import flagship
    from uptune_tpu_torch.parallel import initialize, make_multihost_mesh
    from uptune_tpu_torch.parallel import mesh as pmesh
    from uptune_tpu_torch.parallel.multihost import shutdown
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    t0 = time.perf_counter()
    cfg = initialize(timeout=120)
    init_s = time.perf_counter() - t0
    mesh = make_multihost_mesh(1, device="cuda")
    eng = flagship(SCALE, history_capacity=CAPACITY, device=dev)
    pmesh.all_gather(mesh, torch.zeros(1, device=dev))   # warm collective
    pmesh.reset_staging()
    se, st, wall, launches = sharded_run(eng, mesh, SEED + 41, PAR_STEPS)
    staging = pmesh.staging()
    qors = pmesh.all_gather(mesh, st.best.qor)
    us = pmesh.all_gather(mesh, st.best.u)
    shutdown()
    print(json.dumps({
        "rank": cfg["process_id"], "backend": cfg["backend"],
        "init_process_group_s": init_s, "mesh": mesh.shape,
        "replicas": se.replicas, "ms_per_step": wall / PAR_STEPS * 1e3,
        "launches": launches, "staging": staging,
        "qor_bits": col_bits(qors.cpu()).tolist(),
        "u_bits": col_bits(us.cpu()).reshape(-1).tolist()}), flush=True)
    return 0


def parallel_phase(cases, feats: tuple, dev) -> dict:
    """The mesh plane on the card at the main path's width (see the
    module docstring): (a) ShardedEngine over local meshes, (b) the
    instance mesh scored by C with global_topk, (c) sharded GP scoring
    through B, (d) a process group of two ranks over gloo and one rank
    over NCCL."""
    import os
    import subprocess
    from uptune_tpu_torch import native
    from uptune_tpu_torch.engine import (BatchedEngine, make_instance_mesh,
                                         surrogate_eval_fn)
    from uptune_tpu_torch.flagship import N_CITIES, flagship
    from uptune_tpu_torch.parallel import (initialize, make_mesh,
                                           make_multihost_mesh,
                                           sharded_gp_score)
    from uptune_tpu_torch.parallel import mesh as pmesh
    from uptune_tpu_torch.parallel.multihost import shutdown
    from uptune_tpu_torch.space.spec import CandBatch
    from uptune_tpu_torch.surrogate import gp, pallas_score as ps
    t_phase = time.perf_counter()
    nc, ncat = feats
    st_gp, xq, best, _, _ = cases["mixed_n1024"]
    out = {"phase": "parallel", "scale": SCALE, "history_capacity": CAPACITY,
           "steps": PAR_STEPS}
    bad = []
    zero = dict.fromkeys(kernel_launches(), 0)
    eng = flagship(SCALE, history_capacity=CAPACITY, device=dev)
    eng.run(eng.init(SEED), 1)                    # warm step
    torch.cuda.synchronize()

    # (a) ShardedEngine over local meshes of the card
    seed = SEED + 41
    se, s14, wall, launches = sharded_run(eng, make_mesh(1, 4, device=dev),
                                          seed, PAR_STEPS)
    native.reset_launches()
    t0 = time.perf_counter()
    fused = eng.run(eng.init(se.replica_seeds(seed)[0]), PAR_STEPS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) / PAR_STEPS * 1e3
    diff = trees_differ(row_of(s14, 0), fused)
    a14 = {"mesh": "1x4", "ms_per_step": wall / PAR_STEPS * 1e3,
           "fused_ms_per_step": fused_ms, "launches": launches,
           "bitwise_equal_fused": not diff, "mismatched": diff[:6]}
    if diff or launches != dict(zero, merge_rows=PAR_STEPS):
        bad.append(f"(a) 1x4: {a14}")
    se22, s22, wall, launches = sharded_run(eng, make_mesh(2, 2, device=dev),
                                            seed, PAR_STEPS)
    q22 = s22.best.qor
    a22 = {"mesh": "2x2", "ms_per_step": wall / PAR_STEPS * 1e3,
           "launches": launches, "replica_qors": q22.tolist(),
           "global_best_is_every_replicas": bool(
               (q22 == q22.min()).all() and (s22.best.u == s22.best.u[0]).all()
               and (s22.best.perms[0] == s22.best.perms[0][0]).all()),
           "best_tour_ok": is_perm_rows(s22.best.perms[0], N_CITIES)}
    if not (a22["global_best_is_every_replicas"] and a22["best_tour_ok"]) \
            or launches != dict(zero, merge_rows=2 * PAR_STEPS):
        bad.append(f"(a) 2x2: {a22}")
    out["sharded_engine"] = [a14, a22]

    # (b) the instance mesh, scored by C, and global_topk
    ev = surrogate_eval_fn(eng.space, st_gp, kind="ei", best_y=best,
                           impl="fused", n_cont=nc, n_cat=ncat)
    be = BatchedEngine(eng, BF_N)
    bm = BatchedEngine(eng, BF_N, mesh=make_instance_mesh(2, device=dev))
    st0 = be.init(SEED + 43)
    tst, cands, keys = torch.func.vmap(eng.propose)(st0)
    n, b = cands.u.shape[:2]
    flat = CandBatch(cands.u.reshape(n * b, -1),
                     tuple(p.reshape(n * b, -1) for p in cands.perms))
    full = ev(flat)
    half = n * b // 2
    split = torch.cat([ev(flat[:half]), ev(flat[half:])])
    c_bitwise = torch.equal(full, split)
    native.reset_launches()
    t0 = time.perf_counter()
    sm = bm.run(st0, PAR_BF_STEPS, eval_fn=ev)
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) / PAR_BF_STEPS * 1e3
    run_launches = kernel_launches()
    su = be.run(st0, PAR_BF_STEPS, eval_fn=ev)
    run_diff = trees_differ(sm, su)
    native.reset_launches()
    gv, gown, gidx = bm.global_topk(st0, TOP_K, ev)
    torch.cuda.synchronize()
    topk_launches = kernel_launches()
    uv, uown, uidx = be.global_topk(st0, TOP_K, ev)
    err, ratio = tol_excess(gv[0], uv[0], SD_TOL, float(st_gp.y_std))
    b_out = {
        "instances": BF_N, "shards": 2, "rows_per_shard": half,
        "steps": PAR_BF_STEPS, "ms_per_step": mesh_ms,
        "launches": run_launches, "c_scores_bitwise_across_row_counts":
            c_bitwise, "run_bitwise_equal_unsharded": not run_diff,
        "run_mismatched": run_diff[:6], "k": TOP_K,
        "global_topk_launches": topk_launches,
        "owners_bitwise": torch.equal(gown, uown),
        "indices_bitwise": torch.equal(gidx, uidx),
        "values_bitwise": torch.equal(gv, uv),
        "values_max_abs_err": err, "values_err_over_tol": ratio,
        "rows_equal": bool((gv == gv[0]).all() and (gown == gown[0]).all())}
    out["instance_mesh"] = b_out
    want_run = dict(zero, acquire_scores=2 * PAR_BF_STEPS,
                    merge_rows=2 * PAR_BF_STEPS,
                    surrogate_features=2 * PAR_BF_STEPS)
    if run_launches != want_run or topk_launches != dict(
            zero, acquire_topk=2, surrogate_features=2):
        bad.append(f"(b) launches {run_launches} / {topk_launches}")
    if not (b_out["owners_bitwise"] and b_out["indices_bitwise"]
            and b_out["rows_equal"]):
        bad.append(f"(b) global_topk differs from the unsharded route")
    if not (b_out["values_bitwise"] or ratio <= 1.0):
        bad.append(f"(b) global_topk values {ratio:.3g}x the sd tolerance")
    # the run is bitwise where C's scores do not depend on the launch's
    # rows; where they do, its scores are held to the sd tolerance above
    if c_bitwise and run_diff:
        bad.append(f"(b) the sharded run differs: {run_diff[:6]}")
    if not c_bitwise:
        _, r = tol_excess(split, full, SD_TOL, float(st_gp.y_std))
        b_out["c_split_err_over_tol"] = r
        if not r <= 1.0:
            bad.append(f"(b) C's split scores {r:.3g}x the sd tolerance")

    # (c) sharded GP scoring: 2 x 6040 rows, B once a shard
    rows = 2 * xq.shape[0]
    q2 = torch.cat([xq, xq.flip(0)]).contiguous()
    m12 = make_mesh(1, 2, device=dev)
    sharded_gp_score(m12, "eval", st_gp, q2, kind="ei", best_y=best,
                     n_cont=nc, n_cat=ncat)       # warm
    torch.cuda.synchronize()
    native.reset_launches()
    got = sharded_gp_score(m12, "eval", st_gp, q2, kind="ei", best_y=best,
                           n_cont=nc, n_cat=ncat)
    torch.cuda.synchronize()
    c_launches = kernel_launches()
    mu1, sd1 = ps.gp_mean_var_scores(st_gp, q2, nc, ncat)
    one = gp.ei_from_moments(mu1, sd1, torch.tensor(best, device=dev))
    blocks = ps.prep_blocks(st_gp, q2, nc, ncat)
    mun, qv = ps.mean_var_tile_plain(*blocks, ps.state_kinv(st_gp))
    mup, sdp = ps.target_moments(mun, qv, st_gp.noise, st_gp.y_mean,
                                 st_gp.y_std)
    plain = gp.ei_from_moments(mup, sdp, torch.tensor(best, device=dev))
    e_one, r_one = tol_excess(got, one, SD_TOL, float(st_gp.y_std))
    e_plain, r_plain = tol_excess(got, plain, SD_TOL, float(st_gp.y_std))
    shard_q = q2[:xq.shape[0]].contiguous()
    sb = ps.prep_blocks(st_gp, shard_q, nc, ncat)
    kinv = ps.state_kinv(st_gp)
    b_ms = median_ms(lambda: ps.mean_var_tile_cuda(*sb, kinv))
    entry_ms = median_ms(lambda: ps.gp_mean_var_scores(st_gp, shard_q, nc,
                                                       ncat))
    parts = [got[:xq.shape[0]].clone(), got[xq.shape[0]:].clone()]
    gather_ms = median_ms(lambda: pmesh.gather_local(parts))
    call_ms_all = call_ms(lambda: sharded_gp_score(
        m12, "eval", st_gp, q2, kind="ei", best_y=best, n_cont=nc,
        n_cat=ncat), reps=10, per_rep=2)
    c_out = {"rows": rows, "shards": 2, "rows_per_shard": xq.shape[0],
             "features": int(xq.shape[1]), "n_train": int(st_gp.x.shape[0]),
             "launches": c_launches,
             "bitwise_one_launch": torch.equal(got, one),
             "one_launch_max_abs_err": e_one, "one_launch_err_over_tol": r_one,
             "plain_max_abs_err": e_plain, "plain_err_over_tol": r_plain,
             "b_ms_per_shard": b_ms, "entry_ms_per_shard": entry_ms,
             "collective_ms": gather_ms,
             "sharded_call_ms": call_ms_all,
             "bound_ms_per_shard": gp_bound(xq.shape[0], int(
                 st_gp.x.shape[0]), int(xq.shape[1]), True, 8)["bound_ms"]}
    out["sharded_gp_score"] = c_out
    if c_launches != dict(zero, gp_mean_var=2) or not (
            r_one <= 1.0 and r_plain <= 1.0):
        bad.append(f"(c) {c_out}")

    # (d) a process group of two ranks on the one card (gloo), against a
    # one-process local mesh of the same shape and seed, then one rank
    # over NCCL
    _, s21, wall, _ = sharded_run(eng, make_mesh(2, 1, device=dev), seed,
                                  PAR_STEPS)
    local = {"qor_bits": col_bits(s21.best.qor.cpu()).tolist(),
             "u_bits": col_bits(s21.best.u.cpu()).reshape(-1).tolist()}
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   UT_COORDINATOR=f"localhost:{port}", UT_NUM_PROCESSES="2",
                   UT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    ranks = []
    try:
        for p in procs:
            txt = p.communicate(timeout=300)[0]
            if p.returncode != 0:
                raise RuntimeError(f"mesh rank failed (rc={p.returncode}): "
                                   f"{txt[-3000:]}")
            ranks.append(json.loads([ln for ln in txt.splitlines()
                                     if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    group_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = initialize(None, 1, 0, backend="nccl", timeout=120)
    nccl_init_s = time.perf_counter() - t0
    try:
        mesh_n = make_multihost_mesh(1, devices=[dev, dev])
        # the communicator forms at the first collective: warm it
        pmesh.all_gather(mesh_n, torch.zeros(1, device=dev))
        pmesh.reset_staging()
        _, sn, nccl_wall, nccl_launches = sharded_run(
            eng, mesh_n, seed, PAR_STEPS)
        nccl_staging = pmesh.staging()
    finally:
        shutdown()
    nccl = {"qor_bits": col_bits(sn.best.qor.cpu()).tolist(),
            "u_bits": col_bits(sn.best.u.cpu()).reshape(-1).tolist()}
    d_out = {
        "ranks": [{k: r[k] for k in ("rank", "backend",
                                     "init_process_group_s", "mesh",
                                     "replicas", "ms_per_step", "launches",
                                     "staging")} for r in ranks],
        "group_wall_s": group_s,
        "ranks_agree": all(r["qor_bits"] == ranks[0]["qor_bits"]
                           and r["u_bits"] == ranks[0]["u_bits"]
                           for r in ranks),
        "equal_local_mesh": ranks[0]["qor_bits"] == local["qor_bits"]
        and ranks[0]["u_bits"] == local["u_bits"],
        "local_ms_per_step": wall / PAR_STEPS * 1e3,
        "nccl": {"backend": cfg["backend"], "launches": nccl_launches,
                 "init_process_group_s": nccl_init_s,
                 "staging": nccl_staging,
                 "ms_per_step": nccl_wall / PAR_STEPS * 1e3,
                 "equal_local_mesh": nccl == local}}
    out["process_group"] = d_out
    if not (d_out["ranks_agree"] and d_out["equal_local_mesh"]
            and d_out["nccl"]["equal_local_mesh"]):
        bad.append(f"(d) the group's bests differ: {d_out}")
    if any(r["backend"] != "gloo" or r["launches"] != dict(
            zero, merge_rows=PAR_STEPS) or not r["staging"]["to_host"]
            for r in ranks):
        bad.append(f"(d) ranks: {d_out['ranks']}")
    if nccl_launches != dict(zero, merge_rows=2 * PAR_STEPS) \
            or nccl_staging["to_host"]:
        bad.append(f"(d) nccl: {d_out['nccl']}")
    # the launches of the phase's main runs, for the kernels line
    out["launches"] = {
        k: a14["launches"][k] + a22["launches"][k] + run_launches[k]
        + topk_launches[k] + c_launches[k]
        + sum(r["launches"][k] for r in ranks) + nccl_launches[k]
        for k in zero}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("parallel: " + "; ".join(bad))
    return out


# -- the tooling plane: NOTEARS, QuickEst, ut-torch-stats -----------------------
# test_notears.py's medium graphs (d 10, 12 edges, n 1500) and one wider
# graph, each drawn on the CPU from its seed by the port's simulate_dag,
# and test_notears.py's covariate construction
NOTEARS_CASES = (("d10_s1", 1, 10, 12, 1500), ("d10_s2", 2, 10, 12, 1500),
                 ("d10_s3", 3, 10, 12, 1500), ("d32_s0", 0, 32, 48, 4000))
NOTEARS_LAMBDA, NOTEARS_F1 = 0.05, 0.8
# card against CPU: where the structure the refit ran on is the same, the
# refit weights are bitwise the same (numpy on the same rows); where a
# near-threshold entry of the iterate fell the other way, they are held
# to the reference's own bar for refit magnitudes (tests/test_notears.py:
# 56-57, 0.25 against the true weights)
NOTEARS_REFIT_TOL = 0.25
# QuickEst: rows, features, held-out rows; the card's predictions against
# the CPU's of the same saved model, in units of each target's std
QE_ROWS, QE_FEATURES, QE_TEST_ROWS = 2000, 256, 500
QE_TARGETS = ("LUT_impl", "FF_impl", "DSP_impl", "BRAM_impl")
QE_R2, QE_PRED_TOL_Y_STD, QE_LASSO_TOL = 0.85, 1e-5, 1e-5
# the C++ header client's demo tuned in the program phase
CPP_LIMIT = 30


def notears_case(name: str, dev) -> dict:
    """One NOTEARS run on `dev`: a graph of NOTEARS_CASES (its F1 against
    the true graph, seconds, subproblems and Adam steps a second, the
    learnt matrix and the structure its refit ran on) or "covariate"
    (test_notears.py's construction: the QoR driven by a directly and by
    b through a, c independent noise; the drivers found)."""
    import numpy as np
    from uptune_tpu_torch.plugins.notears import (covariate_graph, notears,
                                                  simulate_dag)
    t0 = time.perf_counter()
    if name == "covariate":
        rs = np.random.RandomState(0)
        b = rs.randn(600)
        a = 1.6 * b + 0.5 * rs.randn(600)
        c = rs.randn(600)
        q = 2.0 * a + 0.4 * rs.randn(600)
        cov = covariate_graph([{"a": a[i], "b": b[i], "c": c[i]}
                               for i in range(600)], q.tolist(),
                              lambda1=NOTEARS_LAMBDA, device=dev)
        return {"device": str(dev), "drivers": cov["drivers"],
                "names": cov["names"], "seconds": time.perf_counter() - t0}
    _, seed, d, edges, n = next(c for c in NOTEARS_CASES if c[0] == name)
    w_true, x = simulate_dag(seed, d, edges, n, device="cpu")
    info = {}
    t0 = time.perf_counter()
    w = notears(x, lambda1=NOTEARS_LAMBDA, device=dev, info=info)
    dt = time.perf_counter() - t0
    tp = float(((w_true != 0) & (w != 0)).sum())
    fp = float(((w_true == 0) & (w != 0)).sum())
    fn = float(((w_true != 0) & (w == 0)).sum())
    return {"device": str(dev), "d": d, "edges": edges, "n": n,
            "f1": 2 * tp / max(2 * tp + fp + fn, 1.0), "seconds": dt,
            "subproblems": info["subproblems"],
            "adam_steps": info["adam_steps"],
            "adam_steps_per_s": info["adam_steps"] / dt,
            "w": np.asarray(w).tolist(),
            "support": info["support"].tolist()}


def notears_child_main(argv) -> int:
    """`chip_smoke.py --notears-run DEVICE NAME...`: runs of the notears
    phase one after another in a process of its own (one torch thread),
    with the kernel launches they made; prints one JSON line."""
    from uptune_tpu_torch import native
    i = argv.index("--notears-run")
    torch.set_num_threads(1)
    dev = torch.device(argv[i + 1])
    native.reset_launches()
    out = {"runs": {name: notears_case(name, dev) for name in argv[i + 2:]}}
    out["launches"] = kernel_launches()
    print(json.dumps(out), flush=True)
    return 0


def notears_phase(dev) -> dict:
    """NOTEARS on the card: test_notears.py's medium graphs (median F1 at
    least its 0.8; each graph's support that of the port's CPU run of
    the same data, its refit weights bitwise where the structure the
    refit ran on is the same and within NOTEARS_REFIT_TOL where it is
    not), its covariate-graph construction (a drives the QoR, c does
    not) and a d 32 graph (F1 and the CPU comparison printed).  An eager
    Adam step is host-bound (~85 launches and one blocking read,
    `matrix_exp`'s norm), so each card run is a process of its own, the
    five at once, beside one process that runs the CPU references one
    after another (`--notears-run DEVICE NAME...`): the wall is about
    that of the slowest card run, each slowed by the others' CUDA
    contexts sharing the card; threads of one process were slower still
    (the interpreter lock); no kernel of the port is launched."""
    import numpy as np
    out = {"phase": "notears", "card": nvidia_smi()}
    bad = []
    t_phase = time.perf_counter()
    names = [c[0] for c in NOTEARS_CASES]
    groups = ([(str(dev), n) for n in names + ["covariate"]]
              + [("cpu", *names)])
    kids = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--notears-run",
         *g], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in groups]
    res, launches = {}, {}
    try:
        for g, p in zip(groups, kids):
            so, se = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"notears runs {g}: {se[-1500:]}")
            o = json.loads(so.strip().splitlines()[-1])
            res.update({(n, g[0]): r for n, r in o["runs"].items()})
            for k, v in o["launches"].items():
                launches[k] = launches.get(k, 0) + v
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["concurrent_processes"] = len(kids)
    out["launches"] = launches
    cov = out["covariate"] = res[("covariate", str(dev))]
    graphs = {}
    for name in names:
        card_r, cpu_r = res[(name, str(dev))], res[(name, "cpu")]
        wg, wc = np.asarray(card_r.pop("w")), np.asarray(cpu_r.pop("w"))
        sg = np.asarray(card_r.pop("support"))
        sc = np.asarray(cpu_r.pop("support"))
        g = {"card": card_r, "cpu": cpu_r,
             "support_equal": bool(((wg != 0) == (wc != 0)).all()),
             "structure_equal": bool((sg == sc).all()),
             "structure_differs_at": np.argwhere(sg != sc).tolist(),
             "refit_max_abs_err": float(np.abs(wg - wc).max())}
        graphs[name] = g
        if name.startswith("d10") and not (
                g["support_equal"]
                and (np.array_equal(wg, wc) if g["structure_equal"]
                     else g["refit_max_abs_err"] <= NOTEARS_REFIT_TOL)):
            bad.append(f"{name}: the card's graph against the CPU's {g}")
    out["graphs"] = graphs
    f1s = [graphs[n]["card"]["f1"] for n in names if n.startswith("d10")]
    out["median_f1_d10"] = float(np.median(f1s))
    if out["median_f1_d10"] < NOTEARS_F1:
        bad.append(f"median F1 {f1s} below {NOTEARS_F1}")
    if "a" not in cov["drivers"] or "c" in cov["drivers"]:
        bad.append(f"covariate drivers {cov['drivers']}")
    if any(launches.values()):
        bad.append(f"kernel launches {launches}")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("notears: " + "; ".join(bad))
    return out


def quickest_data(seed: int, n: int):
    """QuickEst rows shaped like tests/test_quickest.py's: QE_FEATURES
    uniform features of which a few drive each target (sums, products,
    squares, a sine) and the rest are noise."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x = rs.rand(n, QE_FEATURES).astype(np.float32)
    y = np.stack([
        3.0 * x[:, 0] + 2.0 * x[:, 1] * x[:, 2] - x[:, 3]
        + 0.5 * np.sin(3 * x[:, 4]) + 0.05 * rs.randn(n),
        1.5 * x[:, 5] + x[:, 6] ** 2 + 0.4 * x[:, 7] + 0.05 * rs.randn(n),
        2.0 * x[:, 8] + x[:, 9] * x[:, 10] + 0.05 * rs.randn(n),
        x[:, 11] + 0.5 * x[:, 12] ** 2 - 0.8 * x[:, 13]
        + 0.05 * rs.randn(n)], 1)
    return x, y.astype(np.float32)


def quickest_phase(dev) -> dict:
    """QuickEst on the card: `train` on QE_ROWS x QE_FEATURES rows and four
    targets with the default options into a model directory, `test` on
    held-out rows (LUT_impl's R2 above QE_R2), the directory loaded on the
    CPU (the same `sel`, predictions within QE_PRED_TOL_Y_STD of each
    target's std), and LUT_impl's lasso on the CPU from the same rows
    (the same `sel`, w within QE_LASSO_TOL of its largest entry); the
    seconds a target of the lasso and of the MLP fit."""
    import shutil
    import tempfile

    import numpy as np
    from uptune_tpu_torch import native
    from uptune_tpu_torch import quickest as qe
    from uptune_tpu_torch.quickest import pipeline
    from uptune_tpu_torch.surrogate import mlp
    out = {"phase": "quickest", "card": nvidia_smi(), "rows": QE_ROWS,
           "features": QE_FEATURES, "targets": list(QE_TARGETS)}
    bad = []
    t_phase = time.perf_counter()
    x, y = quickest_data(SEED, QE_ROWS)
    xt, yt = quickest_data(SEED + 1, QE_TEST_ROWS)
    tmp = Path(tempfile.mkdtemp(prefix="ut_quickest_"))
    times = {"lasso": [], "mlp": []}
    lasso, mlp_fit = pipeline._lasso_fit, mlp.fit
    lasso_rows = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(kind, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            sync()
            times[kind].append(time.perf_counter() - t0)
            if kind == "lasso":
                lasso_rows.append((a[0].cpu(), a[1].cpu(), a[2], r))
            return r
        return run
    try:
        pipeline._lasso_fit = timed("lasso", lasso)
        mlp.fit = timed("mlp", mlp_fit)
        native.reset_launches()
        t0 = time.perf_counter()
        try:
            est = qe.train(x, y, list(QE_TARGETS), save_dir=str(tmp / "db"),
                           device=dev)
        finally:
            pipeline._lasso_fit, mlp.fit = lasso, mlp_fit
        out["train_seconds"] = time.perf_counter() - t0
        out["lasso_seconds"] = dict(zip(QE_TARGETS, times["lasso"]))
        out["mlp_seconds"] = dict(zip(QE_TARGETS, times["mlp"]))
        t0 = time.perf_counter()
        out["test"] = qe.test(xt, yt, list(QE_TARGETS),
                              model_dir=str(tmp / "db"), device=dev)
        out["test_seconds"] = time.perf_counter() - t0
        out["launches"] = kernel_launches()
        cpu = qe.QuickEst.load(str(tmp / "db"), device="cpu")
        errs = {}
        for j, t in enumerate(QE_TARGETS):
            pg, pc = est.predict(xt, t), cpu.predict(xt, t)
            errs[t] = float(np.abs(pg - pc).max() / yt[:, j].std())
            if not (np.array_equal(cpu.models[t].sel, est.models[t].sel)
                    and errs[t] <= QE_PRED_TOL_Y_STD
                    and np.isfinite(pg).all()):
                bad.append(f"{t}: CPU load sel / predictions "
                           f"({errs[t]} std)")
        out["cpu_load_pred_err_over_y_std"] = errs
        # LUT_impl's lasso again on the CPU, from the rows the card had
        xs, ys, lam, (wg, _) = lasso_rows[0]
        wg, wc = wg.cpu().numpy(), pipeline._lasso_fit(xs, ys, lam)[0].numpy()

        def selected(w):     # _TargetModel.fit's selection
            sel = np.argsort(-np.abs(w))[:32]
            return np.sort(sel[np.abs(w[sel]) > 1e-6])
        lerr = float(np.abs(wg - wc).max() / np.abs(wg).max())
        out["lasso_cpu"] = {"w_err_over_max": lerr, "sel_equal": bool(
            np.array_equal(selected(wc), selected(wg)))}
        if lerr > QE_LASSO_TOL or not out["lasso_cpu"]["sel_equal"]:
            bad.append(f"lasso card against CPU: {out['lasso_cpu']}")
        out["sel"] = {t: est.models[t].sel.tolist() for t in QE_TARGETS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not out["test"]["LUT_impl"]["r2"] > QE_R2:
        bad.append(f"LUT_impl R2 {out['test']['LUT_impl']}")
    if any(out["launches"].values()):
        bad.append(f"kernel launches {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("quickest: " + "; ".join(bad))
    return out


def stats_phase(prog: dict) -> dict:
    """`ut-torch-stats` over the program phase's archive (the rosenbrock
    tune through the CLI on the card), as a user runs it: the report's
    evaluations sum to the archive's rows, and `--csv` writes the
    per-technique convergence (one row a trial that improved its
    technique's best, each at its row of the archive)."""
    import shutil

    from uptune_tpu_torch.utils import stats
    out = {"phase": "stats", "card": nvidia_smi()}
    bad = []
    t_phase = time.perf_counter()
    arc = Path(prog["archive"])
    try:
        rows = stats.load_archive(str(arc))
        cmd = [sys.executable, "-m", "uptune_tpu_torch.utils.stats",
               str(arc)]
        r = subprocess.run(cmd + ["--json"], capture_output=True, text=True,
                           timeout=120, cwd=str(ROOT))
        rep = json.loads(r.stdout)
        csv = arc.parent / "conv.csv"
        r2 = subprocess.run(cmd + ["--csv", str(csv)], capture_output=True,
                            text=True, timeout=120, cwd=str(ROOT))
        lines = csv.read_text().strip().splitlines()
        conv = stats.convergence(rows)
        out.update(
            archive_rows=len(rows), techniques=len(rep),
            report_evals=sum(st["evals"] for st in rep.values()),
            csv_rows=len(lines) - 1,
            convergence_points=sum(len(v) for v in conv.values()),
            table=r2.stdout.splitlines())
        idx = [int(line.split(",")[1]) for line in lines[1:]]
        if not (r.returncode == 0 == r2.returncode
                and out["report_evals"] == len(rows) > 0
                and lines[0] == "technique,eval_index,best_so_far"
                and out["csv_rows"] == out["convergence_points"] > 0
                and all(0 <= i < len(rows) for i in idx)):
            bad.append(f"ut-torch-stats: {out}, {r.stderr[-500:]}")
    finally:
        shutil.rmtree(arc.parent, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("stats: " + "; ".join(bad))
    return out


# the short name of every kernel function of csrc/*.cu (with its template
# arguments) within ptxas's mangled one
PTXAS_KERNEL = re.compile(
    r"(merge_rows_kernelILi\d+E|launch_floor_kernel|kinv_prep_kernel|"
    r"wq_kernel|moments_kernel|topk_merge_kernel|final_kernelILb\dE|"
    r"krows_kernelILb\dELb\dELb\dE|krows_mma_kernelILb\dELb\dELb\dE|"
    r"gp_mean_kernelILb\dELb\dELb\dE|rng_block_kernelILb\dE|"
    r"surrogate_feats_kernel|simplex_propose_kernel)")


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


def passes_profile(fns: dict, calls: int = 10) -> dict:
    """Device time by kernel of each launcher's kernels (A's one, B's,
    C's and D's passes): a torch.profiler window over `calls` calls of
    each of `fns` ({kernel name: call}, `launcher_calls`)."""
    from torch.autograd import DeviceType
    out = {}
    for name, fn in fns.items():
        fn()
        prof = profiled(lambda: [fn() for _ in range(calls)])
        rows = sorted(((e.self_device_time_total, e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and SENTINEL_KERNEL not in e.key), reverse=True)
        out[name] = {"device_us_per_call": sum(r[0] for r in rows) / calls,
                     "passes": [{"name": k[:90],
                                 "device_us_per_call": us / calls,
                                 "count_per_call": c / calls}
                                for us, k, c in rows]}
    return out


def emit_passes(cases, wide_state) -> None:
    """The passes profile at the main state (F 31) and at gp_wide's main
    state (F 1028), one profile line each."""
    from uptune_tpu_torch.ops import acquire as acq
    for key, (st, xq, best, nc, ncat) in (("mixed_n1024", cases["mixed_n1024"]),
                                          ("gp_wide", wide_state)):
        blocks, kinv, params = acq.prep(st, xq, "ei", best, BETA, nc, ncat)
        for name, v in passes_profile(
                launcher_calls(blocks, kinv, params)).items():
            emit({"phase": "profile", "path": f"{name}_passes",
                  "state": key, "features": int(xq.shape[1]), **v})


# the phases of a full run, in order, each with the phases whose results
# it takes (`--phases` runs those too)
PHASES = {
    "merge": (), "rng": (), "features": (), "simplex": (), "surrogate": (),
    "gp_kernels": ("surrogate",),
    "gp_wide": (), "engine": (), "reference": ("engine",),
    "surrogate_engine": ("engine", "surrogate"), "batched": (),
    "batched_flagship": ("surrogate",),
    "topk_batched": ("surrogate",), "tf32": ("surrogate",),
    "portfolio_flagship": ("surrogate",), "portfolio_batched": (),
    "driver": (), "surrogate_driver": (), "serve": (), "route": (),
    "store": (), "parallel": ("surrogate",),
    "program": (), "obs": ("engine", "surrogate", "program"),
    "notears": (), "quickest": (), "stats": ("program",),
}


def phases_to_run(names) -> list:
    """The phases `--phases` names (None: all of them) with the phases
    they take results from, in the full run's order."""
    if names is None:
        return list(PHASES)
    want = set()

    def add(name):
        if name not in PHASES:
            raise SystemExit(f"chip_smoke: no phase {name!r} (phases: "
                             f"{', '.join(PHASES)})")
        want.add(name)
        for dep in PHASES[name]:
            add(dep)
    for name in names:
        add(name)
    return [name for name in PHASES if name in want]


def profile_paths(r: dict) -> None:
    """With --profile: device time by kernel over a few steps or tickets
    of every path whose phase ran, and the passes of A-D at F 31 and
    F 1028."""
    if "engine" in r:
        eng, st, engine = r["engine"]
        profile_phase(eng.step, st, engine["ms_per_step"])
    if "surrogate_engine" in r:
        eng = r["engine"][0]
        surr, st_s, ev, ev_mean, ev_ei = r["surrogate_engine"]
        profile_phase(lambda s: eng.step(s, eval_fn=ev), st_s,
                      surr["fused_ms_per_step"], name="surrogate_engine")
        profile_phase(lambda s: eng.step(s, eval_fn=ev_mean), st_s,
                      surr["score_flat_ms_per_step"],
                      name="score_flat_mean_engine")
        profile_phase(lambda s: eng.step(s, eval_fn=ev_ei), st_s,
                      surr["score_flat_ms_per_step"],
                      name="score_flat_ei_engine")
    if "batched" in r:
        multi, (be_m, st_m) = r["batched"]
        profile_phase(lambda s: be_m.run(s, 1), st_m,
                      multi["runs"][0]["ms_per_step"],
                      name=f"batched_n{MULTI_N}")
    if "batched_flagship" in r:
        flag, (be_f, st_f, ev_f) = r["batched_flagship"]
        profile_phase(lambda s: be_f.run(s, 1, eval_fn=ev_f), st_f,
                      flag["ms_per_step"], name=f"batched_flagship_n{BF_N}")
    if "portfolio_flagship" in r:
        pflag, (eng_pf, st_pf, ev_pf) = r["portfolio_flagship"]
        profile_phase(eng_pf.step, st_pf, pflag["plain_ms_per_step"],
                      name="portfolio_flagship")
        profile_phase(lambda s: eng_pf.step(s, eval_fn=ev_pf), st_pf,
                      pflag["scored_ms_per_step"],
                      name="portfolio_flagship_scored")
    if "portfolio_batched" in r:
        pbat, (be_pb, st_pb) = r["portfolio_batched"]
        profile_phase(lambda s: be_pb.run(s, 1), st_pb, pbat["ms_per_step"],
                      name=f"portfolio_batched_n{PB_N}")
    if "driver" in r:
        drv, tuner = r["driver"]
        profile_phase(lambda s: (tuner.step(), s)[1], None,
                      drv["ms_per_ticket"], name="driver_ticket")
    if "surrogate_driver" in r:
        sdrv, stuner = r["surrogate_driver"]
        profile_phase(lambda s: (stuner.step(), s)[1], None,
                      sdrv["calibrated"]["ms_per_ticket"],
                      name="surrogate_driver_ticket")
    if "surrogate" in r and "gp_wide" in r:
        emit_passes(r["surrogate"][0], r["gp_wide"]["main_state"])


# -- main --------------------------------------------------------------------------
def main() -> int:
    # the store, parallel and notears phases' child processes
    if "--store-child" in sys.argv:
        return store_child_main(sys.argv[1:])
    if "--mesh-rank" in sys.argv:
        return mesh_rank_main()
    if "--notears-run" in sys.argv:
        return notears_child_main(sys.argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few engine steps")
    ap.add_argument("--gp-times", action="store_true",
                    help="time A-D and profile their passes at F 31 and "
                         "F 1028 alone (the A/B mode; no ok line)")
    ap.add_argument("--phases", type=lambda v: v.split(","), default=None,
                    metavar="NAME,...",
                    help="run these phases (and those whose results they "
                         "take) for an A/B call; no kernels line and no ok "
                         "line (phases: " + ", ".join(PHASES) + ")")
    ap.add_argument("--tree", type=Path, default=None,
                    help="with --gp-times: import the port from this "
                         "checkout instead of the script's own")
    args = ap.parse_args()
    if args.phases is not None:
        phases_to_run(args.phases)           # an unknown name exits here
    if args.tree is not None:
        if not args.gp_times:
            ap.error("--tree needs --gp-times")
        sys.path.insert(0, str(args.tree.resolve()))

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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

    if args.gp_times:
        t0 = time.perf_counter()
        native.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        gp_times_phase(dev)
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    libs = native.build()
    kernels = native.KERNELS
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: str(p.relative_to(ROOT)) for k, p in libs.items()},
          "ptxas": {str(k.library_path().relative_to(ROOT)): ptxas_summary(
              k.build_log) for k in kernels}})

    todo = phases_to_run(args.phases)
    r = {}
    if "merge" in todo:
        r["merge"] = merge_phase(dev, args.profile)
    if "rng" in todo:
        r["rng"] = rng_phase(dev)
    if "features" in todo:
        r["features"] = features_phase(dev)
    if "simplex" in todo:
        r["simplex"] = simplex_phase(dev)
    if "surrogate" in todo:
        r["surrogate"] = surrogate_phase(dev)
    if "gp_kernels" in todo:
        r["gp_kernels"] = gp_kernels_phase(r["surrogate"][0])
    if "gp_wide" in todo:
        r["gp_wide"] = gp_wide_phase(dev)
    if "engine" in todo:
        r["engine"] = engine_phase(dev)
    if "reference" in todo:
        reference_phase(*r["engine"][:2], dev)
    if "surrogate_engine" in todo:
        r["surrogate_engine"] = surrogate_engine_phase(
            r["engine"][0], *r["surrogate"], dev)
    if "batched" in todo:
        r["batched"] = batched_phase(dev)
    if "batched_flagship" in todo:
        r["batched_flagship"] = batched_flagship_phase(*r["surrogate"], dev)
    if "topk_batched" in todo:
        r["topk_batched"] = topk_batched_phase(*r["surrogate"], dev)
    if "tf32" in todo:
        tf32_phase(*r["surrogate"], dev)
    if "portfolio_flagship" in todo:
        r["portfolio_flagship"] = portfolio_flagship_phase(*r["surrogate"],
                                                           dev)
    if "portfolio_batched" in todo:
        r["portfolio_batched"] = portfolio_batched_phase(dev)
    if "driver" in todo:
        r["driver"] = driver_phase(dev)
    if "surrogate_driver" in todo:
        r["surrogate_driver"] = surrogate_driver_phase(dev)
    if "serve" in todo:
        r["serve"] = serve_phase(dev)
    if "route" in todo:
        r["route"] = route_phase(dev, r.get("serve"))
    if "store" in todo:
        r["store"] = store_phase(dev)
    if "parallel" in todo:
        r["parallel"] = parallel_phase(*r["surrogate"], dev)
    if "program" in todo:
        r["program"] = program_phase(dev)
    if "obs" in todo:
        r["obs"] = obs_phase(r["engine"], r["program"],
                             r["surrogate"][0], dev)
    if "notears" in todo:
        r["notears"] = notears_phase(dev)
    if "quickest" in todo:
        r["quickest"] = quickest_phase(dev)
    if "stats" in todo:
        r["stats"] = stats_phase(r["program"])
    if args.profile:
        profile_paths(r)
    if args.phases is not None:
        emit({"phase": "total", "seconds": time.perf_counter() - t_start,
              "phases": todo})
        torch.cuda.synchronize()
        print(smi, flush=True)
        emit({"phases_ok": todo})
        return 0

    merge, timed, timed_driver = r["merge"]
    _, gp_times = r["gp_kernels"]
    wide = r["gp_wide"]
    engine = r["engine"][2]
    surr = r["surrogate_engine"][0]
    multi = r["batched"][0]
    flag = r["batched_flagship"][0]
    pflag = r["portfolio_flagship"][0]
    pbat = r["portfolio_batched"][0]
    drv = r["driver"][0]
    sdrv = r["surrogate_driver"][0]
    prog = r["program"]
    topkb = r["topk_batched"]
    serve = r["serve"]["card"]
    route = r["route"]["sharded"]
    store = r["store"]
    par = r["parallel"]["launches"]
    entries = []
    for k in kernels:
        common = {"name": k.name, "route": "cuda",
                  "source": str(k.source.relative_to(ROOT)),
                  "replaces": ", ".join(k.replaces), "matched": True}
        if k is native.FEATURES:
            main = r["features"]["shapes"][FEATURE_SHAPES[0][0]]
            entries.append(dict(
                common, launches=surr["launches"]["surrogate_features"],
                mismatches=sum(c["mismatches"] for c in
                               r["features"]["shapes"].values()),
                shape=f"b={main['b']} d={main['d']} f={main['f']}",
                ms=main["ms"], kernel_ms=main["ms"],
                call_ms=main["call_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="bytes",
                library_ms=None, shapes=r["features"]["shapes"]))
            continue
        if k is native.RNG:
            main = r["rng"]["timed"][str(RNG_COUNTS[-1])]
            entries.append(dict(
                common, launches=engine["rng_block"]["launches"],
                elements=engine["rng_block"]["elements"],
                mismatches=r["rng"]["mismatches"],
                shape=f"count={RNG_COUNTS[-1]}", ms=main["draw"]["ms"],
                kernel_ms=main["draw"]["ms"],
                call_ms=main["draw"]["call_ms"],
                plain_ms=main["draw"]["plain_ms"],
                bound_ms=main["draw"]["bound_ms"], bound_by="bytes",
                library_ms=None, timed=r["rng"]["timed"]))
            continue
        if k is native.SIMPLEX:
            main = r["simplex"]["shapes"][SIMPLEX_SHAPES[1][0]]
            entries.append(dict(
                common, launches=engine["simplex_propose"],
                mismatches=sum(sum(m.values()) for c in
                               r["simplex"]["shapes"].values()
                               for m in c["mismatches"].values()),
                shape=f"s={main['s']} d={main['d']} n={main['n']}",
                ms=main["ms"], kernel_ms=main["ms"],
                call_ms=main["call_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by="bytes",
                library_ms=None, shapes=r["simplex"]["shapes"]))
            continue
        batched = {"launches_batched": multi["runs"][0]["launches"][k.name],
                   "launches_batched_flagship": flag["launches"][k.name],
                   "launches_portfolio_flagship": pflag["launches"][k.name],
                   "launches_portfolio_batched": pbat["launches"][k.name],
                   "launches_driver": drv["launches"][k.name],
                   "launches_surrogate_driver": sum(
                       sdrv[r]["launches"][k.name] for r in (
                           "calibrated", "large_pool", "mlp")),
                   "launches_program": prog["in_process"]["launches"][
                       k.name],
                   "launches_program_gcc": prog["gcc"]["launches"][k.name],
                   "launches_propose_topk": topkb["propose_topk"][
                       "launches"][k.name],
                   "launches_serve": serve["launches"][k.name],
                   # the traced shards of the route phase's scaling run
                   # (their device traces: the merge's, and the GP
                   # kernels' functions, of which none may appear)
                   "launches_route": (route["merge_launches"]
                                      if k.name == "merge_rows"
                                      else route["gp_kernel_events"]),
                   # each store child's own (its wrapper's count, equal
                   # to its commits and, in the cooperating fleet, to its
                   # traced merge kernels), summed over the six
                   "launches_store": sum(
                       c["merge_launches"] for c in store["children"].values())
                   if k.name == "merge_rows" else 0,
                   "launches_parallel": par[k.name]}
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
                    "topk_timed"].items()},
                "instance_axis": [{key: c[key] for key in (
                    "shape", "ms", "ms_second_round", "single_launches_ms",
                    "single_launches_ms_second_round", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "max_abs_err",
                    "max_err_over_tol")} for c in topkb["shapes"]]}
               if k.name == "acquire_topk" else {}),
            **{f"f{wide['features']}": {key: wide["timed"][k.name][key]
                                        for key in WIDE_KEYS}},
            **{f"{kind}_only_f{WIDE_SINGLE}": {
                key: v[k.name][key] for key in WIDE_KEYS
                if key in v[k.name]}
               for kind, v in wide["single_kind_timed"].items()},
            **({f"f{wide['features']}_manager_shapes": {
                str(n): {key: v[key] for key in WIDE_KEYS if key in v}
                for n, v in wide["topk_manager_timed"].items()}}
               if k.name == "acquire_topk" else {})))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": entries})
    torch.cuda.synchronize()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
