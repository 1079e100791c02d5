"""Work counts from the shapes, and the H100's published peaks.

Frozen copies of ``chip_smoke.py``'s ``mlp_macs`` and ``bwd_macs`` (the
multiply-adds a point of one MLP pass needs, forward and backward: no
recompute counted, no culled sample discounted), extended by the semantic
head, and the bytes a pass must read and write at least. Each function
counts the mathematics of a pass whatever kernel computes it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3 bandwidth.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4


def live_skips(depth, skips):
    """Skip connections that feed a later trunk layer."""
    return [s for s in skips if s < depth - 1]


def head_macs(width, n_classes):
    """The semantic head's two dense layers, a point."""
    return width * (width // 2) + (width // 2) * n_classes if n_classes else 0


def mlp_macs(depth, width, e_p, e_v, skips, S, n_classes=0):
    """Forward multiply-adds a point (the view layer's per-ray term spread
    over the ray's S points)."""
    m = (e_p * width + (depth - 1) * width * width
         + len(live_skips(depth, skips)) * e_p * width)
    m += width + width * width + width * (width // 2) + (width // 2) * 3
    return m + e_v * (width // 2) / S + head_macs(width, n_classes)


def bwd_macs(depth, width, e_p, e_v, skips, S, n_classes=0):
    """Backward multiply-adds a point: one a weight for its gradient, one
    a weight that feeds an activation for the input gradients (none into
    the encodings)."""
    fwd = mlp_macs(depth, width, e_p, e_v, skips, S, n_classes)
    return (2 * fwd - e_p * width * (1 + len(live_skips(depth, skips)))
            - e_v * (width // 2) / S)


def passes(cfg, n_rays):
    """``(net spec, samples a ray, points)`` of the coarse and the fine
    pass of ``n_rays`` rays."""
    Sc, Sf = cfg["N_samples"], cfg["N_samples"] + cfg["N_importance"]
    return [(cfg["nets"]["coarse"], Sc, n_rays * Sc),
            (cfg["nets"]["fine"], Sf, n_rays * Sf)]


def _fwd(cfg, net, S):
    return mlp_macs(net["depth"], net["width"], cfg["e_p"], cfg["e_v"],
                    net["skips"], S, cfg["num_classes"])


def _bwd(cfg, net, S):
    return bwd_macs(net["depth"], net["width"], cfg["e_p"], cfg["e_v"],
                    net["skips"], S, cfg["num_classes"])


def step_flops(cfg, n_rays):
    """FLOPs of one training step's MLP passes, forward and backward."""
    return sum(2 * P * (_fwd(cfg, net, S) + _bwd(cfg, net, S))
               for net, S, P in passes(cfg, n_rays))


def frame_flops(cfg, n_rays):
    """FLOPs of a served frame's two forward passes."""
    return sum(2 * P * _fwd(cfg, net, S) for net, S, P in passes(cfg, n_rays))


def _weight_bytes(cfg, net):
    w, d = net["width"], net["depth"]
    n = (cfg["e_p"] * w + (d - 1) * w * w + len(live_skips(d, net["skips"])) * cfg["e_p"] * w
         + w + w * w + (w + cfg["e_v"]) * (w // 2) + (w // 2) * 3
         + head_macs(w, cfg["num_classes"]))
    return n * BF16


def fwd_bytes(cfg, net, S, P):
    """A forward pass's least traffic: each ray's origin, direction and
    view direction, each sample's depth read; the raw rgb and density
    written in float32; the bf16 weights read once."""
    return (P // S) * 9 * F32 + P * F32 + P * 4 * F32 + _weight_bytes(cfg, net)


def acts_bytes(cfg, net, P):
    """The bf16 activations a saved-activation forward writes and its
    backward reads: every trunk layer, the feature and view layers and,
    with a head, its hidden layer."""
    w = net["width"]
    per = net["depth"] * w + w + w // 2 + (w // 2 if cfg["num_classes"] else 0)
    return P * per * BF16


def bwd_bytes(cfg, net, S, P):
    """A saved-activation backward's least traffic: the activations read,
    the cotangent of the raw outputs read, the inputs read again, the
    float32 weight gradients written."""
    return (acts_bytes(cfg, net, P) + P * (4 + cfg["num_classes"]) * F32
            + (P // S) * 9 * F32 + P * F32 + 2 * _weight_bytes(cfg, net))


def bound_s(flops, nbytes):
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the memory bandwidth."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


def frame_fwd_bound_s(cfg, n_rays):
    """Kernel 1's bound over a served frame (both passes)."""
    return sum(bound_s(2 * P * _fwd(cfg, net, S), fwd_bytes(cfg, net, S, P))
               for net, S, P in passes(cfg, n_rays))


def bwd_bound_s(cfg, n_rays, which):
    """The saved-activation backward's bound over a step: ``which`` is
    ``"fine"`` (kernel 5: the fine pass of an RGB step) or ``"both"``
    (kernel 8: both passes of a semantic step, head backward included)."""
    sel = passes(cfg, n_rays)
    if which == "fine":
        sel = sel[1:]
    return sum(bound_s(2 * P * _bwd(cfg, net, S), bwd_bytes(cfg, net, S, P))
               for net, S, P in sel)
