"""ML plugins: NOTEARS causal discovery in torch (the counterpart of
`uptune_tpu.plugins`); the surrogate-model plugins live in
`uptune_tpu_torch.surrogate`, the QuickEst estimator in
`uptune_tpu_torch.quickest`."""
from .notears import covariate_graph, h_func, notears, simulate_dag

__all__ = ["notears", "h_func", "covariate_graph", "simulate_dag"]
