"""Batched search techniques: every arm and meta-technique of the JAX
package, as draw steps plus pure functions on tensors."""
from .base import (Best, Technique, all_technique_names, get_root,
                   get_technique, register)

__all__ = ["Best", "Technique", "all_technique_names", "get_root",
           "get_technique", "register"]
