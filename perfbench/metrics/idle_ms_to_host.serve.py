"""``idle_ms_to_host.serve``: device-idle ms a frame while the host was in
the program's ``frame.to_host`` span (``render_path``'s copies of the
maps to the host; ``yardstick.spans``)."""

from yardstick import spans


def read(ctx):
    return spans.idle_ms(ctx, "frame", ("frame.to_host",))
