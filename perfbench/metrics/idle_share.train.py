"""``idle_share.train``: the share of the traced window in which rank 0's card
ran nothing: 1 - the union of its kernel, copy and set intervals over the
window."""

from yardstick import trace


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)
