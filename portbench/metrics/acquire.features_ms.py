"""acquire.features_ms (ms/unit): the time of the program's
`acquire.features` spans (the GP's features of C's and D's queries,
`surrogate_transform(features(cands))`, apart from their launch) inside
the traced window, over its units."""


def read(ctx):
    spans = [s for s in ctx.extra.get("obs_spans") or ()
             if s.name == "acquire.features" and s.start >= ctx.t0
             and s.end <= ctx.t1]
    if not spans or not ctx.units:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / ctx.units
