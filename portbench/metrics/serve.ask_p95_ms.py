"""serve.ask_p95_ms (ms): the 95th percentile of every ask sent in the
window, from its send to its reply, on the client processes' clock.  The
mix offers more than the server completes, so each connection sends its
next ask as soon as its last turn ends: by Little's law this wait and
the end-to-end `trials_per_s` move together, and the queue of turns
that the offered rate builds up on the clients is left out of it."""


def read(ctx):
    v = ctx.extra.get("ask_p95_ms")
    return None if v is None else float(v)
