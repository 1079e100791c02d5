"""``step_host_ms.train``: the median host duration of the program's
``step`` span (``train/step.py``: draw, render, losses, backward and
optimizer as the host issues them) over the window's steps. Nothing to
read where the program records no spans."""

import statistics

from yardstick import spans


def read(ctx):
    s = spans.split(ctx, "step")
    if s is None:
        return None
    return 1e3 * statistics.median(s.unit_host_s)
