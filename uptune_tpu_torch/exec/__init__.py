"""The black-box evaluation plane: subprocess measurement, sandboxed
worker pools, and the program-tuning controller that drives the port's
Tuner through its ask/tell surface (the JAX package's `exec/`).

The reference's Ray-actor execution layer
(`python/uptune/api.py:813-910` RunProgram, `api.py:399-594`
async_execute, `src/single_stage.py:13-82`) becomes a dependency-free
subprocess pool: the search side runs on the card, so the host side only
needs cheap process supervision.
"""
from .measure import call_program
from .pool import WorkerPool
from .controller import ProgramTuner
from .space_io import space_from_params, stage_spaces, default_config

__all__ = ["call_program", "WorkerPool", "ProgramTuner",
           "space_from_params", "stage_spaces", "default_config"]
