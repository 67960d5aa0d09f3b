"""The surrogates: `gp` (fit, predict, acquisition), `pallas_score` (the
fused scoring tiles, CUDA kernels on the card), `mlp` (the MLP ensemble),
`screen` (the cross-payload feature screen) and `manager` (the
`SurrogateManager` the `Tuner` drives)."""
from . import gp, pallas_score  # noqa: F401
