"""engine.exchange_ms (ms/unit): the time of the program's
`engine.exchange` spans (`exchange_best` across the instances' bests in
a `BatchedEngine` step) and `engine.global_topk` spans (`exchange_topk`,
the pooled top k of the instances' lists) inside the traced window,
over its units.  None from a program without the exchange's span."""


def read(ctx):
    spans = [s for s in ctx.extra.get("obs_spans") or ()
             if s.name in ("engine.exchange", "engine.global_topk")
             and s.start >= ctx.t0 and s.end <= ctx.t1]
    if not ctx.units or not any(s.name == "engine.exchange" for s in spans):
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / ctx.units
