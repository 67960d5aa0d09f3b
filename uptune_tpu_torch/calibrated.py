"""Calibrated surrogate settings.

Counterpart of `uptune_tpu/calibrated.py`, carried over as it is (the
port keeps its own copy; it imports nothing).

Selected by the calibration grid (scripts/calibrate_tpu.py) and
validated at 30 seeds (BENCHREPORT.md): EI top-k concentration of
technique batches plus the surrogate proposal plane.  These are the
defaults the CLI / ProgramTuner apply when a learning model is enabled
by name; library users override any key via `surrogate_opts`.  The
measurements behind them were taken with the JAX package.
"""

CALIBRATED_OPTS = {
    "min_points": 16, "refit_interval": 16, "max_points": 256,
    "select": "topk", "keep_frac": 0.35, "explore_frac": 0.1,
    "score": "ei", "propose_batch": 8, "propose_every": 2,
    "pool_mult": 64,
}

# Not in the calibrated dict (the schedule is the measured default):
# `arbitration='bandit'` turns the proposal plane into a credit-earning
# virtual arm of the AUC bandit (driver applies pull-size parity to the
# pool batch; the run-budget passivation rule still applies).  Opt in
# via `ut --surrogate-arbitration bandit` or surrogate_opts; measured
# tradeoffs in BENCHREPORT.md ("Bandit-arbitrated plane").

# The measured recommendation for BUDGET-CONSTRAINED real-build tuning
# (eval budget comparable to or below the parameter count, e.g. 80
# compiles over a ~330-flag gcc space): let the AUC credit arbitrate
# with affordable 8-eval pulls instead of passivating the plane.  At 30
# matched seeds on gcc-real this is the best measured configuration —
# median 25 iters vs baseline 28.5 (0.88x), solve-rate 28/30, vs the
# passive rule's 28/4-censored (BENCHREPORT.md "Why the surrogate...",
# exp_bandit_gccreal_r4f.jsonl).  CLI: --learning-models gp
# --surrogate-arbitration bandit-small-budget.
BUDGET_CONSTRAINED_OPTS = {
    **CALIBRATED_OPTS,
    "arbitration": "bandit",
    "auto_passive": False,
    "propose_batch_parity": False,
}
