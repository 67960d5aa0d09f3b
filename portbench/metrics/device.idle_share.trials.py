"""The device's idle share (%): the part of the traced window in which
no kernel, copy or set runs (the union of their intervals in the
torch.profiler trace), split by name by the end-to-end metric its cells
report."""
from portbench import devtrace


def read(ctx):
    if not len(ctx.ops) or ctx.t1 <= ctx.t0:
        return None
    busy = devtrace.busy_ns(ctx.ops, ctx.t0, ctx.t1)
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))
