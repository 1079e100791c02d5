"""Work counts of a patch step, from the shapes: VGG19's convolutions and
the two legs' MLP passes, and the least bytes each must move.

VGG19 runs on three crops a patch step: the ground truth (no gradient)
and the two rendered ones (fine and coarse), whose input gradient the
backward takes; its weights are frozen, so no weight gradient is taken.
Each 3x3 convolution costs ``H W C_in C_out 9`` multiply-adds a crop at
its resolution (halved, floored, by each pool), forward and for the input
gradient alike. VGG19 runs in float32 storage with TF32 products where
cuDNN takes them (the configuration's ``assumed``): its bound is its
operations at the TF32 peak. The legs' counts are
:mod:`yardstick.counts`' at the legs' ray counts.
"""

from __future__ import annotations

from yardstick import counts
from yardstick.reference_patch import legs, vgg_layers

# NVIDIA H100 SXM data sheet, dense TF32 tensor cores.
PEAK_FLOPS_TF32 = 494.7e12
F32 = 4


def vgg_shapes(taps, H: int, W: int):
    """``(h, w, c_in, c_out)`` of each convolution up to the deepest tap."""
    out = []
    for _, c_in, c_out, pool in vgg_layers(taps):
        if pool:
            H, W = H // 2, W // 2
        out.append((H, W, c_in, c_out))
    return out


def vgg_macs(taps, H: int, W: int) -> int:
    """Multiply-adds of one crop's forward pass (as of its input gradient)."""
    return sum(h * w * ci * co * 9 for h, w, ci, co in vgg_shapes(taps, H, W))


def vgg_step_flops(taps, H: int, W: int) -> float:
    """A patch step's VGG19 FLOPs: three crops forward, two input
    gradients."""
    return 2.0 * vgg_macs(taps, H, W) * (3 + 2)


def vgg_step_bytes(taps, H: int, W: int) -> float:
    """A patch step's least VGG19 traffic: the float32 weights read by the
    two forward calls and the backward, the three crops read, every tap
    written by the forward and its cotangent read by the backward for the
    two rendered crops, the two input gradients written."""
    weights = sum(ci * co * 9 + co for _, _, ci, co in vgg_shapes(taps, H, W))
    shapes = dict(zip([n for n, *_ in vgg_layers(taps)], vgg_shapes(taps, H, W)))
    tap_elems = sum(h * w * co for n, (h, w, _, co) in shapes.items() if n in taps)
    return F32 * (3 * weights + 3 * H * W * 3 + (3 + 2) * tap_elems + 2 * H * W * 3)


def vgg_bound_s(taps, H: int, W: int) -> float:
    return max(vgg_step_flops(taps, H, W) / PEAK_FLOPS_TF32,
               vgg_step_bytes(taps, H, W) / counts.PEAK_BYTES)


def patch_flops(cfg, steps: int, rays_ng: int, rays_grad: int) -> float:
    """What ``steps`` patch steps add to base steps: the no-grad leg's two
    forward passes over ``rays_ng`` rays, the grad leg's forward and
    backward over ``rays_grad``, VGG19's of each step."""
    return (counts.frame_flops(cfg, rays_ng) + counts.step_flops(cfg, rays_grad)
            + vgg_step_flops(cfg["vgg_layers"], cfg["nH"], cfg["nW"]) * steps)


def ng_fwd_bound_s(cfg) -> float:
    """Kernel 6's bound over a patch step's no-grad leg: both passes'
    forward, the semantic head's included."""
    return counts.frame_fwd_bound_s(cfg, legs(cfg)[0])
