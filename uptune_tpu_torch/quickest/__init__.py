"""QuickEst: fast QoR estimation from early-stage features, in torch.

Counterpart of `uptune_tpu.quickest`: predicts post-implementation FPGA
resource/timing (LUT/FF/DSP/BRAM, slack) from early HLS report features.
The per-target model is an L1 linear model (ISTA) for feature selection
-> the port's MLP ensemble (`uptune_tpu_torch.surrogate.mlp`) on the
selected features -> a stacked combination of the linear and MLP heads
fit on a validation split; the models run on the card unless the caller
passes ``device="cpu"``, and persist as npz + json in the JAX package's
layout.
"""
from .analyze import (analyze, feature_importance, hls_scores,
                      learning_curve, rrse, scores)
from .hlsreport import discover_operations, extract, scrape_checkpoint
from .pipeline import (QuickEst, load_csv, predict, preprocess, test,
                       train)

__all__ = ["QuickEst", "preprocess", "train", "test", "predict",
           "load_csv", "analyze", "scores", "hls_scores",
           "learning_curve", "feature_importance", "rrse",
           "extract", "discover_operations", "scrape_checkpoint"]
