"""``collective_exposed_ms.train``: NCCL kernel time a step on rank 0 that
no compute kernel overlaps (the gathers of the per-ray outputs and the
all-reduce of the gradients, ``parallel/gather.py``)."""

from yardstick import trace


def read(ctx):
    tr, c = ctx["trace"], ctx["counts"]
    if not c.get("steps") or not any(trace.is_nccl(n) for n, _, _ in tr.device):
        return None
    return 1e3 * trace.exposed_nccl_s(tr) / c["steps"]
