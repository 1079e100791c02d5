"""``idle_ms_patch.train_patch``: device-idle ms a patch step while the
host was inside one of the program's ``patch.*`` spans (the no-grad
tiles, the grad leg, the content loss, the smoothness;
``yardstick.patch_trace``), over the window's patch steps. Nothing to read
where the program records no patch spans."""

from yardstick import spans, trace


def read(ctx):
    c, tr = ctx["counts"], ctx["trace"]
    ranges = c.get("patch_spans")
    if not ranges or not c.get("patch_steps") or not tr.device:
        return None
    idle = spans.idle_intervals(tr)
    t = sum(trace.overlap(gap, ranges) for gap in idle)
    return 1e3 * t / c["patch_steps"]
