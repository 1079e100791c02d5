"""``culled_live_share.train``: the share of kernel 3's 64-point tiles that
are live (``cull.live_tiles``, summed on the device, over ``cull.tiles``,
counted on the host, in ``ops/fused_mlp_t.py:_bwd_culled_dparams``): the
useful share of the culled recompute backward's work over the window.
Nothing to read where no culled backward ran or the program counts none."""

from yardstick import spans


def read(ctx):
    rec = spans.recorder()
    if rec is None:
        return None
    tiles = rec.counters().get("cull.tiles", 0)
    if not tiles:
        return None
    return 100.0 * rec.device_counters().get("cull.live_tiles", 0.0) / tiles
