"""``idle_ms_optimizer.train``: device-idle ms a step while the host was in
the program's ``step.optimizer`` span (the Adam step and
``invalidate_packs``; ``yardstick.spans``)."""

from yardstick import spans


def read(ctx):
    return spans.idle_ms(ctx, "step", ("step.optimizer",))
