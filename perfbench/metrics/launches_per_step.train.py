"""``launches_per_step.train``: the kernel launches the program's wrappers
made over the traced window (``utils.tracing.session_launches``: the
launch registry's change since the window's profiler began, a split
backward's call counted once under each phase it launched and not again
under its wrapper), over the window's steps. Nothing to read where the
program has no registry."""

from yardstick import spans


def read(ctx):
    rec = spans.recorder()
    s = spans.split(ctx, "step")
    if rec is None or s is None:
        return None
    return sum(rec.session_launches().values()) / s.units
