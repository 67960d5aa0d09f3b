"""uptune-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

The package mirrors `uptune_tpu/` module for module, so each counterpart
sits at the same relative path.  It imports `torch`, never `jax`, and
nothing of `uptune_tpu`: where it needs a jax-free module of the JAX
package it keeps its own copy (`space/params.py`).

Ported so far (the fused tuning step end to end, the GP surrogate, and
the batched multi-instance engine):

* `space`      — parameter specs, the flat encoding, codecs and hashing;
* `ops`        — numeric and permutation operators, the dedup merge
                 (`ops/dedup.py`, a CUDA kernel in `csrc/merge.cu`), the
                 fused acquisition (`ops/acquire.py`);
* `techniques` — PureRandom, GreedyMutation, DifferentialEvolution,
                 NelderMead;
* `driver.history` — the device-resident dedup history;
* `engine.fused`   — `FusedEngine` (init / propose / commit / step / run);
* `engine.batched` — `BatchedEngine`, `exchange_best` and the surrogate
                 evaluator; `tune_batch` (`api/batch.py`) on top;
* `surrogate`  — the GP and its kernels (`csrc/gp_tile.cu`);
* `flagship`   — the mixed-space flagship workload;
* `convert`    — a JAX engine state (as numpy arrays) -> the port's.

Entry points take `device=` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.  Randomness comes
from keys carried in the state (`rng`, a counter-based generator), and
every stochastic op is split into a draw step (consumes a key's stream)
and a pure function of the draws, so tests can feed the pure part the
numbers JAX drew.
"""

from .api.batch import BatchTuneResult, tune_batch  # noqa: F401,E402
