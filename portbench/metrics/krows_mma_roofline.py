"""krows_mma_roofline (%): the least time of the distances' cross term
of one kernel-rows pass, times the launches of B, C and D on the
tensor-core route in the window (the program's counter by route), over
the summed time of `krows_mma_kernel` in the trace."""
from portbench.roofline import HBM_BYTES_PER_S, TF32_FLOP_PER_S


def cross_term_bound(b: int, n: int, f: int) -> float:
    """Seconds: the cross term of b query rows against n training rows
    of f features, 2bnf operations counted three times at the TF32 rate
    (3xTF32 keeps float32's accuracy), or the two operands' floats read
    once at HBM's rate, whichever takes longer."""
    return max(3 * 2 * b * n * f / TF32_FLOP_PER_S,
               4 * (b + n) * f / HBM_BYTES_PER_S)


def read(ctx):
    routes = ctx.extra.get("route_launches") or {}
    calls = sum(r.get("tensor_cores", 0) for r in routes.values())
    mask = ctx.ops.matching("krows_mma_kernel")
    spent = ctx.ops.seconds(mask)
    if not mask.any() or not calls or spent <= 0:
        return None
    s = ctx.shapes
    bound = cross_term_bound(s["rows"], s["train_rows"], s["features"])
    return 100.0 * calls * bound / spent
