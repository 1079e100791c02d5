"""``mfu.serve``: the whole served frame's share of the card's bf16 peak.

The FLOPs of both passes' forward over every frame served in the window
(``yardstick.counts.frame_flops``) over the traced window's seconds times
989 TFLOP/s."""

from yardstick import counts


def read(ctx):
    c = ctx["counts"]
    if not c.get("frames"):
        return None
    flops = counts.frame_flops(ctx["plain"], c["n_rays"]) * c["frames"]
    return 100.0 * flops / (ctx["trace"].window_s * counts.PEAK_FLOPS_BF16 * c["chips"])
