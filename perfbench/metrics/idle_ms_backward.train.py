"""``idle_ms_backward.train``: device-idle ms a step while the host was in
the program's ``step.loss`` (every loss term) or ``step.backward``
(``zero_grad``, ``backward``, the gradient all-reduce) spans
(``yardstick.spans``)."""

from yardstick import spans


def read(ctx):
    return spans.idle_ms(ctx, "step", ("step.loss", "step.backward"))
