"""engine.device_ops_per_step (ops/step): the device's kernels, copies
and sets in the traced window over the units run in it (a unit is one
FusedEngine.step, and its propose_topk where the mix has one)."""


def read(ctx):
    if not len(ctx.ops) or not ctx.units:
        return None
    return len(ctx.ops) / ctx.units
