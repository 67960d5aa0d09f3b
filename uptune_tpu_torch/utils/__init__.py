"""Host-side helpers of the port: `pypath` (the child-process import
seam), `net` and `stats` (`ut-torch-stats`, the archive report)."""
