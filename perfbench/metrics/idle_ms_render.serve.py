"""``idle_ms_render.serve``: device-idle ms a frame while the host was in
the program's ``frame.rays`` (``camera_rays`` and ``make_rays``) or
``frame.tile`` (one ``render_rays_tiled`` tile) spans
(``yardstick.spans``)."""

from yardstick import spans


def read(ctx):
    return spans.idle_ms(ctx, "frame", ("frame.rays", "frame.tile"))
