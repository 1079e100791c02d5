"""The benchmark's scene and weights, made on the device from the seed.

The scene is the port's synthetic world (``data/synthetic.py:draw_scene``:
three coloured spheres before a textured wall at z = -6, traced from
cameras on an arc, sparse "LiDAR" z-depths at random pixels), rewritten in
PyTorch so that it is traced on the card in a few large calls. The wall
carries class ids 4..C-1 by region, so that a semantic head sees every
class.

Every seed gets the same work in another order: the scene and the
function the weights compute are the same for all seeds, and the seed
draws the order of each layer's hidden units (a permutation that leaves
the function unchanged), the path's phase and, in the step generators,
which rays a step takes. (Weights drawn afresh from each seed made a field
that stops most rays at their first samples on some seeds, which the
culled backward skips: 45% more steps in a window on one seed of three.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from yardstick.reference import TrainData, mlp_layers

BLOBS = (((0.0, 0.0, -4.0), 1.0, (0.9, 0.2, 0.2)),
         ((1.2, 0.6, -5.0), 0.8, (0.2, 0.8, 0.3)),
         ((-1.1, -0.5, -3.5), 0.6, (0.2, 0.3, 0.9)))
BG = (0.05, 0.05, 0.08)
TARGET = (0.0, 0.0, -4.0)
# Lecun-normal weights as Flax draws them: a unit normal truncated at two
# standard deviations (here clipped), rescaled by this constant.
TRUNC_STD = 0.87962566103423978


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0] >> 1)


def generator(device, seed: int, tag: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def look_at(eye: torch.Tensor, target=TARGET) -> torch.Tensor:
    """Camera-to-world ``[..., 3, 4]``, -z forward."""
    z = eye - torch.tensor(target, dtype=eye.dtype, device=eye.device)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    up = torch.tensor((0.0, 1.0, 0.0), dtype=eye.dtype, device=eye.device).expand(z.shape)
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z, eye], -1)


# The draws that are the same for every seed: the cameras' offsets, the
# LiDAR pixels and the weights' values.
BASE_SEED = 0


def train_poses(n_views: int, seed: int, device) -> torch.Tensor:
    """``draw_scene``'s arc of cameras, each moved by up to 0.05."""
    vi = torch.arange(n_views, dtype=torch.float32, device=device)
    a = (vi / max(n_views - 1, 1) - 0.5) * 0.5
    eye = torch.stack([torch.sin(a) * 1.5, 0.15 * torch.sin(vi),
                       torch.cos(a) * 0.4], -1)
    jitter = torch.rand((n_views, 3), device=device,
                        generator=generator(device, seed, 1)) - 0.5
    return look_at(eye + 0.1 * jitter)


def spiral_poses(n_poses: int, seed: int, device) -> torch.Tensor:
    """The served path: a spiral about the arc's middle camera (the LLFF
    ``render_poses``' shape), its phase drawn from the seed."""
    phase = float(torch.rand((), device="cpu", generator=torch.Generator().manual_seed(
        sub_seed(seed, 2)))) * 2 * math.pi
    th = torch.arange(n_poses, dtype=torch.float32, device=device) * (4 * math.pi / n_poses) + phase
    eye = torch.stack([0.6 * torch.cos(th), 0.3 * torch.sin(th),
                       0.4 + 0.15 * torch.sin(0.5 * th)], -1)
    return look_at(eye)


def trace(ro, rd, num_classes: int):
    """rgb ``[N, 3]``, ray parameter of the hit ``[N]``, class ``[N]``."""
    n = ro.shape[0]
    dev = ro.device
    rgb = torch.tensor(BG, device=dev).expand(n, 3).clone()
    t_hit = torch.full((n,), 1e5, device=dev)
    cls = torch.zeros(n, dtype=torch.int32, device=dev)
    dz = torch.where(rd[:, 2].abs() < 1e-9, torch.full_like(rd[:, 2], -1e-9), rd[:, 2])
    t_wall = (-6.0 - ro[:, 2]) / dz
    hit = t_wall > 0.1
    p = ro + rd * t_wall[:, None]
    tex = 0.5 + 0.25 * torch.sin(3.0 * p[:, 0]) * torch.sin(2.0 * p[:, 1])
    rgb = torch.where(hit[:, None], torch.stack([tex, tex * 0.8, tex * 0.6], -1), rgb)
    t_hit = torch.where(hit, t_wall, t_hit)
    if num_classes > 4:
        region = (torch.floor(p[:, 0] * 1.5) * 3 + torch.floor(p[:, 1] * 1.5)).long()
        wall_cls = 4 + torch.remainder(region, num_classes - 4).int()
        cls = torch.where(hit, wall_cls, cls)
    rr = (rd * rd).sum(-1)
    for label, (c, r, col) in enumerate(BLOBS, start=1):
        oc = ro - torch.tensor(c, device=dev)
        b = (oc * rd).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - cc * rr
        t = (-b - torch.sqrt(torch.clamp(disc, min=0))) / rr
        closer = (disc > 0) & (t > 0.1) & (t < t_hit)
        t_hit = torch.where(closer, t, t_hit)
        rgb = torch.where(closer[:, None], torch.tensor(col, device=dev).expand(n, 3), rgb)
        cls = torch.where(closer, torch.full_like(cls, label), cls)
    return rgb, t_hit, cls


def make_scene(cfg: dict, seed: int, device) -> TrainData:
    """The training views of a configuration (``H``, ``W``, ``focal``,
    ``n_train_views``, ``num_classes``, ``lidar_points_per_view``)."""
    H, W, f, V = cfg["H"], cfg["W"], cfg["focal"], cfg["n_train_views"]
    poses = train_poses(V, BASE_SEED, device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    dirs = torch.stack([(i - W * 0.5) / f, -(j - H * 0.5) / f, -torch.ones_like(i)], -1)
    rd = (dirs.reshape(1, -1, 1, 3) * poses[:, None, :3, :3]).sum(-1)  # [V, HW, 3]
    ro = poses[:, None, :3, 3].expand(rd.shape)
    C = cfg["num_classes"]
    rgb, t_hit, cls = trace(ro.reshape(-1, 3), rd.reshape(-1, 3), C)
    images = rgb.reshape(V, H, W, 3).contiguous()
    seg = cls.reshape(V, H, W).contiguous() if cfg["semantic_loss"] else None
    coord = depth = weight = None
    K = cfg["lidar_points_per_view"]
    if cfg["colmap_depth"]:
        # Every ray meets the wall, so any pixel carries a depth.
        pick = torch.rand((V, H * W), device=device,
                          generator=generator(device, BASE_SEED, 3)).argsort(-1)[:, :K]
        coord = torch.stack([pick % W, pick // W], -1).float()
        t = t_hit.reshape(V, H * W).gather(1, pick)
        rdp = rd.gather(1, pick[..., None].expand(V, K, 3))
        depth = t * -(rdp * poses[:, None, :3, 2]).sum(-1)
        weight = torch.ones_like(depth)
    return TrainData(images, poses, seg, coord, depth, weight)


def _permute(p: dict, layers, depth: int, skips, e_p: int, g) -> dict:
    """``p`` with each hidden layer's units in an order drawn from ``g``:
    a layer's rows (and bias) and the matching columns of every layer that
    reads it, so that the net computes the same function."""
    def perm(n):
        return torch.randperm(n, device=g.device, generator=g)

    def rows(name, q):
        p[name + ".weight"] = p[name + ".weight"][q]
        p[name + ".bias"] = p[name + ".bias"][q]

    def cols(name, q, off=0):
        w = p[name + ".weight"]
        idx = torch.arange(w.shape[1], device=w.device)
        idx[off:off + q.numel()] = off + q
        p[name + ".weight"] = w[:, idx]

    names = {n for n, _, _ in layers}
    for i in range(depth):
        q = perm(p[f"trunk_{i}.weight"].shape[0])
        rows(f"trunk_{i}", q)
        # [x, h] after a skip: the units sit after the encoding.
        off = e_p if i in skips else 0
        for reader in ([f"trunk_{i + 1}"] if i + 1 < depth else ["sigma", "feature"]):
            cols(reader, q, off)
    q = perm(p["feature.weight"].shape[0])
    rows("feature", q)
    cols("views_0", q)
    if "semantic_0" in names:
        cols("semantic_0", q)
        q = perm(p["semantic_0.weight"].shape[0])
        rows("semantic_0", q)
        cols("semantic_1", q)
    q = perm(p["views_0.weight"].shape[0])
    rows("views_0", q)
    cols("rgb", q)
    return {k: v.contiguous() for k, v in p.items()}


def make_weights(cfg: dict, seed: int, device, tag: int = 10):
    """Both MLPs' float32 parameters under the port's names (``trunk_0.
    weight``, ...): Lecun-normal weights from one normal draw on the card
    a net (the same for every seed), zero biases, each hidden layer's units
    in an order drawn from ``seed``; with ``serving_field`` the density
    head scaled and offset and the colour head scaled, so that a frame has
    no empty ray."""
    out = {}
    for n_i, net in enumerate(("coarse", "fine")):
        spec = cfg["nets"][net]
        layers = mlp_layers(spec["depth"], spec["width"], cfg["e_p"], cfg["e_v"],
                            spec["skips"], cfg["num_classes"])
        total = sum(a * b for _, a, b in layers)
        z = torch.randn(total, device=device,
                        generator=generator(device, BASE_SEED, tag + n_i))
        z = torch.clamp(z, -2.0, 2.0)
        p, off = {}, 0
        for name, fan_in, fan_out in layers:
            w = z[off:off + fan_in * fan_out].reshape(fan_out, fan_in)
            off += fan_in * fan_out
            p[name + ".weight"] = w * (math.sqrt(1.0 / fan_in) / TRUNC_STD)
            p[name + ".bias"] = torch.zeros(fan_out, device=device)
        p = _permute(p, layers, spec["depth"], spec["skips"], cfg["e_p"],
                     generator(device, seed, tag + 5 + n_i))
        sf = cfg.get("serving_field")
        if sf:
            p["sigma.weight"] *= sf["sigma_scale"]
            p["sigma.bias"] += sf["sigma_offset"]
            p["rgb.weight"] *= sf["rgb_scale"]
        out[net] = p
    return out
