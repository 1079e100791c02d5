"""``patch_host_ms.train_patch``: the median host duration of the
program's ``step`` span over the window's patch steps (those whose span
holds a ``patch.*`` span, ``train/step.py``). Nothing to read where the
program records no patch spans."""

import statistics

from yardstick import spans


def read(ctx):
    rec = spans.recorder()
    if rec is None:
        return None
    recs = rec.records()
    roots = set()
    for k, r in enumerate(recs):
        if not r.name.startswith("patch."):
            continue
        while recs[k].parent is not None:
            k = recs[k].parent
        if recs[k].name == "step" and recs[k].t1_ns is not None:
            roots.add(k)
    if not roots:
        return None
    return 1e-6 * statistics.median(recs[k].t1_ns - recs[k].t0_ns for k in roots)
