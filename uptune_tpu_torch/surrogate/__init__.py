"""The GP surrogate: `gp` (fit, predict, acquisition) and `pallas_score`
(the fused scoring tiles, CUDA kernels on the card)."""
from . import gp, pallas_score  # noqa: F401
