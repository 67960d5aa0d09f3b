"""uptune-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

The package mirrors `uptune_tpu/` module for module, so each counterpart
sits at the same relative path.  It imports `torch`, never `jax`, and
nothing of `uptune_tpu`: where it needs a jax-free module of the JAX
package it keeps its own copy (`space/params.py`, `calibrated.py`,
`driver/plugins.py`, `driver/objectives.py`, `driver/inputs.py`).

Every module of the JAX package has its counterpart here but three
(`ops/routing.py`, `analysis/trace_guard.py`, `utils/platform_guard.py`:
a mode knob, a jit-retrace counter and a JAX platform guard, which the
port has no use for):

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
                 or surrogate snapshot -> the port's;
* `exec`, `api`, `store`, `cli` — program mode: `python -m
                 uptune_tpu_torch.cli script.py` (or `ut-torch`) tunes a
                 program through the `UT_*` protocol; the child side
                 (`ut.tune`, `ut.target`, ...) is the JAX package's, byte
                 for byte, so a program importing either package is
                 served.
* `serve`, `obs`, `parallel` — the serving plane, observability and the
                 mesh plane;
* `plugins`    — NOTEARS causal discovery (`plugins.notears`);
* `quickest`   — the QuickEst estimator (`train`, `test`, `predict`,
                 `analyze`, `extract`);
* `analysis`   — `ut-torch-lint` (the JAX package's rules) and
                 `LockGuard`; `utils.stats` — `ut-torch-stats`.

Entry points take `device=` and default to ``"cuda"``; without a card
they raise unless the caller passes ``device="cpu"``.  Randomness comes
from keys carried in the state (`rng`, a counter-based generator), and
every stochastic op is split into a draw step (consumes a key's stream)
and a pure function of the draws, so tests can feed the pure part the
numbers JAX drew.

The package is lazy, as the JAX package's is: ``import uptune_tpu_torch
as ut; ut.tune(...)`` in a tuned child program imports neither torch nor
the engine, only the protocol modules.
"""
__version__ = "0.2.0"

_LAZY = {
    # public name -> (module, attribute)
    "tune": ("uptune_tpu_torch.api.tuneapi", "tune"),
    "target": ("uptune_tpu_torch.api.report", "target"),
    "interm": ("uptune_tpu_torch.api.report", "interm"),
    "feature": ("uptune_tpu_torch.api.report", "feature"),
    "save": ("uptune_tpu_torch.api.report", "save"),
    "get_global_id": ("uptune_tpu_torch.api.report", "get_global_id"),
    "get_local_id": ("uptune_tpu_torch.api.report", "get_local_id"),
    "get_meta_data": ("uptune_tpu_torch.api.report", "get_meta_data"),
    "config": ("uptune_tpu_torch.api.session", "config"),
    "init": ("uptune_tpu_torch.api.session", "init"),
    "get_best": ("uptune_tpu_torch.api.session", "get_best"),
    "rule": ("uptune_tpu_torch.api.constraint", "rule"),
    "constraint": ("uptune_tpu_torch.api.constraint", "constraint"),
    "register": ("uptune_tpu_torch.api.constraint", "register"),
    "vars": ("uptune_tpu_torch.api.constraint", "vars"),
    "model": ("uptune_tpu_torch.api.tuner", "model"),
    "settings": ("uptune_tpu_torch.api.session", "settings"),
    "tune_batch": ("uptune_tpu_torch.api.batch", "tune_batch"),
    "BatchTuneResult": ("uptune_tpu_torch.api.batch", "BatchTuneResult"),
    "vhls": ("uptune_tpu_torch.api.features", "vhls"),
    "quartus": ("uptune_tpu_torch.api.features", "quartus"),
    "Tuner": ("uptune_tpu_torch.driver", "Tuner"),
    "TuneResult": ("uptune_tpu_torch.driver", "TuneResult"),
    "StepStats": ("uptune_tpu_torch.driver", "StepStats"),
    "connect": ("uptune_tpu_torch.serve.client", "connect"),
    "LocalSession": ("uptune_tpu_torch.serve.session", "LocalSession"),
    # QuickEst estimator pipeline, analysis and HLS-report extraction
    "preprocess": ("uptune_tpu_torch.quickest", "preprocess"),
    "train": ("uptune_tpu_torch.quickest", "train"),
    "test": ("uptune_tpu_torch.quickest", "test"),
    "predict": ("uptune_tpu_torch.quickest", "predict"),
    "analyze": ("uptune_tpu_torch.quickest", "analyze"),
    "extract": ("uptune_tpu_torch.quickest", "extract"),
}

def __getattr__(name):
    """The lazy public API: the module of a name is imported on first
    use."""
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'uptune_tpu_torch' has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(modname), attr)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
