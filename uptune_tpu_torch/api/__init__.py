"""User-facing API layer of the port: so far `tune_batch` (`batch`)."""
