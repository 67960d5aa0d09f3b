"""Host-side helpers of the port (so far `pypath`, the child-process
import seam)."""
