"""Child-process import seam: make `import uptune_tpu_torch` (and, from a
checkout, `import uptune_tpu`, which the unchanged samples do) work in
spawned subprocesses (analysis runs, sandboxed eval workers, --num-hosts
replicas) even from a plain checkout with no `pip install -e .`.

For an installed package the computed directory is site-packages —
already importable, so the entry is inert.
"""
from __future__ import annotations

import os
from typing import Optional


def pkg_parent_dir() -> str:
    """Directory CONTAINING the uptune_tpu_torch package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def child_pythonpath(existing: Optional[str] = None) -> str:
    """PYTHONPATH value for a child process: the package parent dir
    prepended to `existing` (defaults to the current environment's)."""
    pp = (os.environ.get("PYTHONPATH", "")
          if existing is None else existing)
    root = pkg_parent_dir()
    if root in pp.split(os.pathsep):
        return pp
    return root + (os.pathsep + pp if pp else "")
