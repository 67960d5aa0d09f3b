"""serve.commit_share (%): the `serve.commit` spans of the program's
obs plane (each held under its group's lock), summed over the window
and set against the window's wall."""


def read(ctx):
    t0, t1 = ctx.extra.get("window", (0, 0))
    held = sum(max(0, min(s.end, t1) - max(s.start, t0))
               for s in ctx.spans if s.name == "serve.commit")
    if not held or t1 <= t0:
        return None
    return 100.0 * held / (t1 - t0)

