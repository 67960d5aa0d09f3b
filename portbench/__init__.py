"""The benchmark of the PyTorch and CUDA port (`uptune_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once and prints one JSON
result line.  Everything that belongs to one configuration, one traffic
mix or one per-layer metric is a file of its own, found by its name:

- `configs/<config>.json`: a deployment (space, arms, sizes, guarantees);
- `traffic/<mix>.json`: a traffic mix, whose `driver` names the general
  window loop in `drivers/` that reads it;
- `limits/<cell>.json`: the limit of each number a cell's judgement
  compares (set from `calibrate.py`'s readings);
- `metrics/<metric>.py`: the reader of one per-layer metric.

The yardstick lives here too: the plain reference (`reference/`), the
peaks and least times (`roofline.py`), the rate and percentile
arithmetic (`stats.py`), the reduction of the device trace
(`devtrace.py`) and the sync counter (`syncs.py`).  Nothing here
imports JAX or the JAX package.
"""
