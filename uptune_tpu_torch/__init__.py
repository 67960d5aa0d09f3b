"""uptune-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

The package mirrors `uptune_tpu/` module for module, so each counterpart
sits at the same relative path.  It imports `torch`, never `jax`, and
nothing of `uptune_tpu`: where it needs a jax-free module of the JAX
package it keeps its own copy (`space/params.py`, `calibrated.py`,
`driver/plugins.py`, `driver/objectives.py`, `driver/inputs.py`).

Ported so far (the fused tuning step end to end, the GP surrogate, the
batched multi-instance engine, every technique, the ask/tell driver and
its surrogate manager):

* `space`      — parameter specs, the flat encoding, codecs and hashing;
* `ops`        — numeric and permutation operators, the dedup merge
                 (`ops/dedup.py`, a CUDA kernel in `csrc/merge.cu`), the
                 fused acquisition (`ops/acquire.py`);
* `techniques` — every technique and meta-technique of the JAX package
                 under its registry name (46; `get_root` for the
                 default AUC-bandit portfolio);
* `driver.history` — the device-resident dedup history;
* `driver.Tuner`   — the ask/tell tuning driver (`ask` / `tell` /
                 `cancel` / `step` / `run`, the jsonl archive and
                 resume), with its hooks (`driver.plugins`), objectives
                 (`driver.objectives`) and input managers
                 (`driver.inputs`);
* `engine.fused`   — `FusedEngine` (init / propose / commit / step / run);
* `engine.batched` — `BatchedEngine`, `exchange_best` and the surrogate
                 evaluator; `tune_batch` (`api/batch.py`) on top;
* `surrogate`  — the GP and its kernels (`csrc/gp_tile.cu`), the MLP
                 ensemble, the feature screen, and the manager
                 (`surrogate.manager.SurrogateManager`: refits, the async
                 snapshot plane, the keep mask and the proposal pool;
                 `Tuner(surrogate="gp" | "mlp")` builds it);
* `workloads`  — the synthetic objectives, on the device and over
                 config dicts for the `Tuner`;
* `flagship`   — the mixed-space flagship workload;
* `convert`    — a JAX engine state (as numpy arrays), GP, MLP ensemble
                 or surrogate snapshot -> the port's.

Entry points take `device=` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.  Randomness comes
from keys carried in the state (`rng`, a counter-based generator), and
every stochastic op is split into a draw step (consumes a key's stream)
and a pure function of the draws, so tests can feed the pure part the
numbers JAX drew.
"""

from .api.batch import BatchTuneResult, tune_batch  # noqa: F401,E402
from .driver import StepStats, TuneResult, Tuner  # noqa: F401,E402
