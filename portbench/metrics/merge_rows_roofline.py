"""merge_rows_roofline (%): the merge's least time (roofline.py, its
bytes at cap and b rows) a call, times its calls in the window (the
program's launch counter), over the summed time of `merge_rows_kernel`
in the trace."""
from portbench import roofline


def read(ctx):
    mask = ctx.ops.matching("merge_rows_kernel")
    calls = ctx.launches.get("merge_rows", 0)
    spent = ctx.ops.seconds(mask)
    if not mask.any() or not calls or spent <= 0:
        return None
    s = ctx.shapes
    bound = roofline.merge_rows_bound(s["cap"], s["rows"])["bound_s"]
    return 100.0 * calls * bound / spent
