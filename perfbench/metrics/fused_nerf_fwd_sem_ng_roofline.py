"""``fused_nerf_fwd_sem_ng_roofline``: kernel 6 (the semantic forward
without saved activations, and its head) on the no-grad patch leg against
its bound.

The bound of the leg's two forward passes (``yardstick.counts_patch.
ng_fwd_bound_s``: the larger of operations at 989 TFLOP/s and least bytes
at 3.35 TB/s) times the patch steps, over the device time of the kernels
named in ``yardstick.patch_trace.KERNEL6`` launched inside the program's
``patch.ng`` spans. Nothing to read without the spans."""

from yardstick import counts_patch


def read(ctx):
    c = ctx["counts"]
    dev = c.get("patch_device_s")
    if not dev or not c.get("patch_steps") or dev["kernel6_ng"] <= 0:
        return None
    return 100.0 * counts_patch.ng_fwd_bound_s(ctx["plain"]) * c["patch_steps"] / dev["kernel6_ng"]
