"""acquire_scores_roofline (%): launcher C's least time (roofline.py) a
call, times its calls in the window (the program's launch counter), over
the summed time of its kernels in the trace (the gp_tile kernels that a
FusedEngine.step launched)."""
from portbench import devtrace, roofline

GP_TILE = (r"kinv_prep_kernel|krows_kernel|krows_mma_kernel|wq_kernel|"
           r"moments_kernel|final_kernel|topk_merge_kernel|gp_mean_kernel")


def read(ctx):
    mask = devtrace.launched_in(ctx.ops, ctx.spans, "engine.step") & \
        ctx.ops.matching(GP_TILE)
    calls = ctx.launches.get("acquire_scores", 0)
    spent = ctx.ops.seconds(mask)
    if not mask.any() or not calls or spent <= 0:
        return None
    s = ctx.shapes
    bound = roofline.acquire_scores_bound(s["rows"], s["train_rows"],
                                          s["features"])["bound_s"]
    return 100.0 * calls * bound / spent
