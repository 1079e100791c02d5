"""``fused_nerf_fwd_roofline``: kernel 1 (the fused eval forward) against
its bound over the served frames.

The bound of a frame's two forward passes (the larger of their operations
at 989 TFLOP/s and their least bytes at 3.35 TB/s,
``yardstick.counts.frame_fwd_bound_s``) times the frames, over the device
time of the kernels named below. Nothing to read where no such kernel ran
(a frame on another route)."""

from yardstick import counts, trace

KERNELS = ("fused_nerf_fwd_kernel",)


def read(ctx):
    c = ctx["counts"]
    t = trace.kernel_time(ctx["trace"], KERNELS)
    if not c.get("frames") or t <= 0:
        return None
    return 100.0 * counts.frame_fwd_bound_s(ctx["plain"], c["n_rays"]) * c["frames"] / t
