"""surrogate.prune_ms (ms/unit): the time of the program's
`surrogate.prune` spans inside the traced window, over its units:
one a scoring `SurrogateManager.keep_mask` (the EI of a technique
batch and its top keep_frac).  None from a program without the span."""
from portbench.drivers.campaign import span_ms


def read(ctx):
    return span_ms(ctx, "surrogate.prune")
