"""surrogate.refit_ms (ms/unit): the time of the program's
`surrogate.refit` spans inside the traced window, over its units:
one a `SurrogateManager.maybe_refit` on the tell path, holding the
inline full fit when one is due (the 43-point `fit_auto` sweep and the
winner's fit) or else the rank-1 extensions.  None from a program
without the span."""
from portbench.drivers.campaign import span_ms


def read(ctx):
    return span_ms(ctx, "surrogate.refit")
