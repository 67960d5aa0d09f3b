"""Batched search techniques (the arms ported so far)."""
from .base import (Best, Technique, all_technique_names, get_technique,
                   register)

__all__ = ["Best", "Technique", "all_technique_names", "get_technique",
           "register"]
