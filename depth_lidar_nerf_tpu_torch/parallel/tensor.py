"""The collective of tensor parallelism over a model group (what GSPMD
inserts around JAX's column-sharded ``Dense`` layers).

A column-parallel layer holds the rows ``[t * out / tp, (t + 1) * out /
tp)`` of an ``nn.Linear``'s ``[out, in]`` weight and of its bias on model
rank ``t``. Its input is the same on every rank of the model group; each
rank computes its columns of the output, and the columns are all-gathered,
so that every rank holds the whole output and runs the same downstream on
it (as every rank of a ray group computes the same loss on the same
gathered rays, :mod:`parallel.gather`).

Backward, every rank therefore receives the whole output's gradient ``g``.
Each computes its rows of the weight's and the bias's gradients from its
columns of ``g``, and the whole input gradient ``g W`` from the whole
weight, which the forward gathered beside the output (``out x in`` values
against the output's ``points x out``). The backward needs no collective,
and the input gradient is one process's product of the same operands:
the same rounding, in bfloat16 too. (Summing the ranks' parts ``g_t W_t``
instead, as a row-parallel layer must, moved ``points x in`` float32
values a layer through the host on two gloo ranks sharing one card, and
made every later step differ from one process's in summation order.)
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F


def gather_shards(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' parts of a tensor split along ``dim`` over ``group``,
    put side by side in rank order (a layer's weight rows, its output
    columns)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _ColumnParallelLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, group):
        whole = gather_shards(weight, group) if ctx.needs_input_grad[0] \
            else None
        ctx.save_for_backward(x, whole)
        n = weight.shape[0]
        ctx.cols = (dist.get_rank(group) * n, (dist.get_rank(group) + 1) * n)
        return gather_shards(F.linear(x, weight, bias), group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, whole = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        mine = g2[:, ctx.cols[0]:ctx.cols[1]]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = g2.mm(whole).view(x.shape)
        return dx, mine.t().mm(x.reshape(-1, x.shape[-1])), mine.sum(0), None


def column_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel ``nn.Linear`` (the module's note): this rank's rows
    ``weight``/``bias`` of the layer applied to ``x`` (the same on every
    rank of ``group``), the whole output gathered; differentiable in all
    three. Computed in ``weight``'s type, as ``F.linear`` computes it."""
    return _ColumnParallelLinear.apply(x, weight, bias, group)
