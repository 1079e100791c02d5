"""``mfu.train``: the whole training step's share of the cards' bf16 peak.

The FLOPs of both MLP passes, forward and backward, of every sample the
window's steps evaluate (``yardstick.counts.step_flops``: no recompute, no
culled sample discounted, the semantic head included), over the traced
window's seconds times 989 TFLOP/s times the cards."""

from yardstick import counts


def read(ctx):
    c = ctx["counts"]
    if not c.get("steps"):
        return None
    flops = counts.step_flops(ctx["plain"], c["n_rays"]) * c["steps"]
    return 100.0 * flops / (ctx["trace"].window_s * counts.PEAK_FLOPS_BF16 * c["chips"])
