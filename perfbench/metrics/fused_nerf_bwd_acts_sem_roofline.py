"""``fused_nerf_bwd_acts_sem_roofline``: kernel 8 (the semantic
saved-activation backward of both passes) against its bound over the
window's steps, on rank 0.

The work is both passes' backward with the head's
(``yardstick.counts.bwd_bound_s(..., "both")``) of rank 0's share of the
batch; the time is that of the kernels which compute it: the head
backward, phase 1 (the chain), phase 2 (the weight gradients) and the
reductions that follow phase 2."""

from yardstick import counts, trace

KERNELS = ("fused_nerf_sem_head_bwd_kernel", "fused_nerf_bwd_acts_kernel",
           "fused_nerf_wgrad_kernel")
REDUCE, AFTER = "fused_nerf_grad_reduce_kernel", "fused_nerf_wgrad_kernel"


def read(ctx):
    c = ctx["counts"]
    t = trace.kernel_time(ctx["trace"], KERNELS) + trace.reduce_after(
        ctx["trace"], REDUCE, AFTER)
    if not c.get("steps") or t <= 0:
        return None
    rays = c["n_rays"] / c["chips"]
    return 100.0 * counts.bwd_bound_s(ctx["plain"], rays, "both") * c["steps"] / t
