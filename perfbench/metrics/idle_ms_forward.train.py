"""``idle_ms_forward.train``: device-idle ms a step while the host was in
the program's ``step.draw`` (the index draw and ray gather of
``train/tables.py``) or ``step.render`` (``render_rays`` under autograd)
spans (``yardstick.spans``)."""

from yardstick import spans


def read(ctx):
    return spans.idle_ms(ctx, "step", ("step.draw", "step.render"))
