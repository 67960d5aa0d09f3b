"""surrogate.pool_ms (ms/unit): the time of the program's
`surrogate.pool` spans inside the traced window, over its units:
one a pull of `SurrogateManager.propose_pool` (the pool's draws, its
512 candidates, their EI and the top 8).  None from a program without
the span."""
from portbench.drivers.campaign import span_ms


def read(ctx):
    return span_ms(ctx, "surrogate.pool")
