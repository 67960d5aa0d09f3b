"""Batched operators over the flat space encoding."""
from . import dedup, numeric, perm  # noqa: F401
