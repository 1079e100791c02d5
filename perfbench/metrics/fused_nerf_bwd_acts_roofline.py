"""``fused_nerf_bwd_acts_roofline``: kernel 5 (the saved-activation
backward of an RGB step's fine pass) against its bound over the window's
steps.

The work is the fine pass's backward (``yardstick.counts.bwd_bound_s(...,
"fine")``); the time is that of phase 1 (the chain), phase 2 (the weight
gradients) and the reductions that follow phase 2 (the coarse pass's
recompute backward has its own)."""

from yardstick import counts, trace

KERNELS = ("fused_nerf_bwd_acts_kernel", "fused_nerf_wgrad_kernel")
REDUCE, AFTER = "fused_nerf_grad_reduce_kernel", "fused_nerf_wgrad_kernel"


def read(ctx):
    c = ctx["counts"]
    t = trace.kernel_time(ctx["trace"], KERNELS) + trace.reduce_after(
        ctx["trace"], REDUCE, AFTER)
    if not c.get("steps") or t <= 0:
        return None
    rays = c["n_rays"] / c["chips"]
    return 100.0 * counts.bwd_bound_s(ctx["plain"], rays, "fine") * c["steps"] / t
