"""Plain float32 PyTorch reference of the benchmarked training step and
served frame.

It follows the reference NeRF (``run_nerf.py`` / ``run_nerf_helpers.py`` of
the depth-lidar-nerf repository): pinhole rays and the NDC warp, the
positional encoding, the MLP with its skip, its density, feature, view and
colour heads and the linear two-layer semantic head, stratified and
inverse-CDF sampling, alpha compositing with the ``1e10`` last interval
(and the samples whose incoming transmittance is below ``cull_eps`` given
zero weight, the configuration's setting), the rgb, depth and semantic
losses and Adam as optax computes it. It imports nothing of the program
and takes nothing that the program made: rays, samples and tables are
worked out again here from the benchmark's scene, weights and seeds.

Matrix products run in float32 with TF32 off (:func:`plain_float32`).
``mm_dtype`` rounds each dense layer's operands to a lower precision (the
control: ``torch.float8_e4m3fn``), with float32 products.

Randomness: a step draws, from a ``torch.Generator`` on the batch's device
seeded with :func:`step_seed`, the rgb ray indices, the depth ray indices,
the stratified jitter ``[N, N_samples]``, the coarse density noise, the
importance draws ``[N, N_importance]`` and the fine density noise
``[N, N_samples + N_importance]``, in that order: the same draws that the
configuration's step makes, so the two sides see one batch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def plain_float32():
    """float32 products: TF32 off for matmuls and cuDNN within."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def step_seed(seed: int, i: int) -> int:
    """Step ``i``'s generator seed: the first 64-bit word of numpy's
    ``SeedSequence([seed, i])`` (the training driver's rule)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])


# ----------------------------------------------------------------- rays ---

def _rotate(dirs, c2w):
    return (dirs[..., None, :] * c2w[..., :3, :3]).sum(-1)


def pixel_rays(H, W, focal, c2w, rows, cols):
    """Rays through pixel centres' integer coordinates ``(rows, cols)``;
    ``c2w [..., 3, 4]`` broadcast against them."""
    dirs = torch.stack([(cols - W * 0.5) / focal, -(rows - H * 0.5) / focal,
                        -torch.ones_like(cols)], -1)
    rd = _rotate(dirs, c2w)
    ro = c2w[..., :3, 3].expand(rd.shape)
    return ro, rd


def ndc(H, W, focal, near, ro, rd):
    t = -(near + ro[..., 2]) / rd[..., 2]
    ro = ro + t[..., None] * rd
    ox, oy, oz = ro.unbind(-1)
    dx, dy, dz = rd.unbind(-1)
    o = torch.stack([-1.0 / (W / (2.0 * focal)) * ox / oz,
                     -1.0 / (H / (2.0 * focal)) * oy / oz,
                     1.0 + 2.0 * near / oz], -1)
    d = torch.stack([-1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz),
                     -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz),
                     -2.0 * near / oz], -1)
    return o, d


class Rays(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    vd: torch.Tensor


def make_rays(cfg, ro, rd) -> Rays:
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    if not cfg["no_ndc"]:
        ro, rd = ndc(cfg["H"], cfg["W"], cfg["focal"], 1.0, ro, rd)
    return Rays(ro, rd, vd)


# ------------------------------------------------------------------ MLP ---

def encode(x, n_freqs):
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], -2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], -1)


def mlp_layers(depth, width, e_p, e_v, skips=(4,), n_classes=0):
    """``(name, fan_in, fan_out)`` of every dense layer, in the order the
    benchmark draws their weights."""
    out, h = [], e_p
    for i in range(depth):
        out.append((f"trunk_{i}", h, width))
        h = width + (e_p if i in skips else 0)
    out += [("sigma", h, 1), ("feature", h, width)]
    if n_classes:
        out += [("semantic_0", width, width // 2),
                ("semantic_1", width // 2, n_classes)]
    out += [("views_0", width + e_v, width // 2), ("rgb", width // 2, 3)]
    return out


class _Round(torch.autograd.Function):
    """A product's operand rounded to ``dtype`` with one scale a tensor (its
    largest magnitude at the format's largest finite value), as a scaled
    low-precision product rounds it; the gradient passes unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        top = torch.finfo(dtype).max
        if top > 1e30:  # float32's exponent range: no scale needed
            return x.to(dtype).float()
        scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / top
        return (x / scale).to(dtype).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def _dense(p, name, x, mm_dtype):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if mm_dtype is not None:
        x = _Round.apply(x, mm_dtype)
        w = _Round.apply(w, mm_dtype)
    return torch.nn.functional.linear(x, w, b)


def mlp(p, depth, skips, pts_enc, views_enc, n_classes, mm_dtype=None):
    """``raw [..., 4 + C]``: rgb logits, density, semantic logits."""
    h = pts_enc
    for i in range(depth):
        h = torch.relu(_dense(p, f"trunk_{i}", h, mm_dtype))
        if i in skips:
            h = torch.cat([pts_enc, h], -1)
    sigma = _dense(p, "sigma", h, mm_dtype)
    feat = _dense(p, "feature", h, mm_dtype)
    h = torch.relu(_dense(p, "views_0", torch.cat([feat, views_enc], -1),
                          mm_dtype))
    parts = [_dense(p, "rgb", h, mm_dtype), sigma]
    if n_classes:
        parts.append(_dense(p, "semantic_1",
                            _dense(p, "semantic_0", feat, mm_dtype), mm_dtype))
    return torch.cat(parts, -1)


def query(p, net, cfg, rays: Rays, z, mm_dtype=None):
    pts = rays.o[:, None, :] + rays.d[:, None, :] * z[..., None]
    ve = encode(rays.vd, cfg["multires_views"])
    ve = ve[:, None, :].expand(pts.shape[:-1] + ve.shape[-1:])
    return mlp(p, net["depth"], net["skips"], encode(pts, cfg["multires"]),
               ve, cfg["num_classes"], mm_dtype)


# ------------------------------------------------------------ rendering ---

def unit_linspace(n, device):
    t = torch.arange(n, dtype=torch.float32, device=device) * (1.0 / (n - 1))
    t[-1] = 1.0
    return t


def composite(raw, z, d, noise, cull_eps, n_classes):
    dists = z[:, 1:] - z[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(d, dim=-1, keepdim=True)
    sigma = raw[..., 3] if noise is None else raw[..., 3] + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    if cull_eps > 0.0:
        w = torch.where(trans >= cull_eps, w, torch.zeros_like(w))
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    depth = (w * z).sum(-1)
    acc = w.sum(-1)
    out = {"rgb": rgb, "depth": depth, "acc": acc, "weights": w,
           "disp": 1.0 / torch.clamp(depth / acc, min=1e-10)}
    if n_classes:
        out["sem"] = raw[..., 4:4 + n_classes].sum(-2)
    return out


def sample_pdf(bins, weights, u):
    """The reference's inverse CDF: +1e-5 floor, zero-prepended CDF,
    ``searchsorted(right)``, clamped gathers, guarded interpolation."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    i = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp(i - 1, min=0)
    above = torch.clamp(i, max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    den = c1 - c0
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


class Draws(NamedTuple):
    t_rand: Optional[torch.Tensor]  # [N, Sc] stratified jitter
    noise_c: Optional[torch.Tensor]  # [N, Sc] coarse density noise (scaled)
    u: torch.Tensor  # [N, Sf] importance draws
    noise_f: Optional[torch.Tensor]  # [N, Sc + Sf] fine density noise


def render(params, cfg, rays: Rays, draws: Draws, mm_dtype=None):
    """Coarse and fine passes of a ray block: the fine maps and the coarse
    ones under ``*0`` keys."""
    n, dev = rays.o.shape[0], rays.o.device
    t = unit_linspace(cfg["N_samples"], dev)
    z = (0.0 * (1.0 - t) + 1.0 * t).expand(n, -1)
    if draws.t_rand is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], -1)
        lower = torch.cat([z[:, :1], mids], -1)
        z = lower + (upper - lower) * draws.t_rand
    nets, C = cfg["nets"], cfg["num_classes"]
    raw = query(params["coarse"], nets["coarse"], cfg, rays, z, mm_dtype)
    co = composite(raw, z, rays.d, draws.noise_c, cfg["cull_eps"], C)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    zs = sample_pdf(z_mid, co["weights"][:, 1:-1].detach(), draws.u).detach()
    z_all = torch.sort(torch.cat([z, zs], -1), -1).values
    raw = query(params["fine"], nets["fine"], cfg, rays, z_all, mm_dtype)
    fi = composite(raw, z_all, rays.d, draws.noise_f, cfg["cull_eps"], C)
    out = dict(fi)
    out.update({k + "0": v for k, v in co.items()})
    return out


# ------------------------------------------------------------- training ---

class TrainData(NamedTuple):
    """The benchmark's scene, as both sides get it: training images
    ``[V, H, W, 3]``, their poses ``[V, 3, 4]``, class ids ``[V, H, W]``
    (or None) and the LiDAR points, ``K`` a view: pixel coordinates
    ``[V, K, 2]`` (x, y), z-depths ``[V, K]`` and weights ``[V, K]``."""

    images: torch.Tensor
    poses: torch.Tensor
    segmentation: Optional[torch.Tensor]
    depth_coord: Optional[torch.Tensor]
    depth: Optional[torch.Tensor]
    depth_weight: Optional[torch.Tensor]


def batch_sizes(cfg):
    n_depth = int(cfg["N_rand"] * cfg["depth_rays_prop"]) if cfg["colmap_depth"] else 0
    return cfg["N_rand"] - n_depth, n_depth


def draw_batch(cfg, data: TrainData, seed: int, i: int, n_rgb: int,
               n_depth: int):
    """Step ``i``'s rays, targets and draws, from its generator."""
    dev = data.images.device
    V, H, W, _ = data.images.shape
    g = torch.Generator(device=dev)
    g.manual_seed(step_seed(seed, i))
    idx = torch.randint(0, V * H * W, (n_rgb,), device=dev, generator=g)
    view, pix = idx // (H * W), idx % (H * W)
    rows, cols = (pix // W).float(), (pix % W).float()
    ro, rd = pixel_rays(H, W, cfg["focal"], data.poses[view], rows, cols)
    tgt = {"rgb": data.images.reshape(-1, 3)[idx]}
    if cfg["semantic_loss"]:
        tgt["sem"] = data.segmentation.reshape(-1)[idx].long()
    if n_depth:
        K = data.depth.shape[1]
        idx_d = torch.randint(0, V * K, (n_depth,), device=dev, generator=g)
        vd_, k = idx_d // K, idx_d % K
        xy = data.depth_coord[vd_, k]
        ro_d, rd_d = pixel_rays(H, W, cfg["focal"], data.poses[vd_],
                                xy[:, 1], xy[:, 0])
        ro, rd = torch.cat([ro, ro_d]), torch.cat([rd, rd_d])
        tgt["depth"] = data.depth[vd_, k]
        tgt["depth_w"] = data.depth_weight[vd_, k]
    n = n_rgb + n_depth
    Sc, Sf = cfg["N_samples"], cfg["N_importance"]
    std = cfg["raw_noise_std"]
    t_rand = torch.rand((n, Sc), device=dev, generator=g)
    noise_c = torch.randn((n, Sc), device=dev, generator=g) * std if std > 0 else None
    u = torch.rand((n, Sf), device=dev, generator=g)
    noise_f = torch.randn((n, Sc + Sf), device=dev, generator=g) * std if std > 0 else None
    return make_rays(cfg, ro, rd), tgt, Draws(t_rand, noise_c, u, noise_f)


def _block_loss(cfg, out, tgt, lo, hi, n_rgb, n_depth, imp, depth_on=True):
    """This block's share of the step's loss, each term a mean over the
    whole batch, and its share of the depth term before its weight (the
    mean squared depth error; 0 where ``depth_on`` is false, the term
    then left out of the loss)."""
    loss = out["rgb"].new_zeros(())
    depth_part = 0.0
    r = max(0, min(hi, n_rgb) - lo)  # rgb rays in the block
    if r:
        for key in ("rgb", "rgb0"):
            loss = loss + ((out[key][:r] - tgt["rgb"][lo:lo + r]) ** 2).sum() / (3 * n_rgb)
        if cfg["semantic_loss"]:
            lab = tgt["sem"][lo:lo + r]
            for key in ("sem", "sem0"):
                logp = torch.log_softmax(out[key][:r], -1)
                ce = -logp.gather(1, lab[:, None]).sum() / n_rgb
                loss = loss + cfg["semantic_lambda"] * ce
    if n_depth and cfg["depth_loss"] and hi > n_rgb:
        a = max(lo, n_rgb)
        dr = out["depth"][a - lo:]
        t = tgt["depth"][a - n_rgb:hi - n_rgb]
        if cfg["weighted_loss"]:
            err = (dr - t) ** 2 * tgt["depth_w"][a - n_rgb:hi - n_rgb]
        else:
            err = (dr - t) ** 2
        if depth_on:
            term = err.sum() / n_depth
            depth_part = float(term.detach())
            loss = loss + cfg["depth_lambda"] * imp * term
    return loss, depth_part


def lr_at(cfg, count: int) -> torch.Tensor:
    f32 = torch.float32
    return (torch.tensor(cfg["lrate"], dtype=f32)
            * torch.tensor(0.1, dtype=f32) ** (torch.tensor(count, dtype=f32)
                                               / torch.tensor(cfg["lrate_decay"] * 1000, dtype=f32)))


class Readings(NamedTuple):
    losses: List[float]  # each step's total loss
    depth_losses: List[float]  # each step's depth term before its weight
    grad_norms: Dict[str, float]  # each leaf's first gradient norm
    change_norms: Dict[str, float]  # each leaf's change after the steps
    grads: Dict[str, torch.Tensor]  # each leaf's first gradient


def train_steps(cfg, data: TrainData, init: Dict[str, Dict[str, torch.Tensor]],
                seed: int, n_steps: int = 3, block: int = 4096,
                mm_dtype=None, fault=None) -> Readings:
    """``n_steps`` training steps from the weights ``init`` (copied), each
    rendered in blocks of ``block`` rays with the gradients summed.
    ``fault`` plants one of the checked faults in this reference (the
    calibration's fault readings): ``"unchanged"`` leaves the parameters
    where they are; ``"half_batch"`` takes every loss term
    over the first half of the batch's rgb and depth rays;
    ``"depth_shifted"`` gives each depth ray the next one's target (a
    depth-table gather one row off); ``"no_depth"`` leaves the depth term
    out of the loss, its reading 0."""
    dev = data.images.device
    params = {net: {k: v.detach().float().clone().to(dev).requires_grad_(True)
                    for k, v in init[net].items()} for net in ("coarse", "fine")}
    leaves = [(f"{net}.{k}", p) for net in params for k, p in params[net].items()]
    m = {k: torch.zeros_like(p) for k, p in leaves}
    v = {k: torch.zeros_like(p) for k, p in leaves}
    n_rgb, n_depth = batch_sizes(cfg)
    losses, depth_losses, grad_norms, grads = [], [], {}, {}
    with plain_float32():
        for i in range(1, n_steps + 1):
            rays, tgt, draws = draw_batch(cfg, data, seed, i, n_rgb, n_depth)
            n_r, n_d = n_rgb, n_depth
            if fault == "half_batch":
                n_r, n_d = n_rgb // 2, n_depth // 2
                keep = torch.cat([torch.arange(n_r, device=dev),
                                  n_rgb + torch.arange(n_d, device=dev)])
                rays = Rays(*(x[keep] for x in rays))
                draws = Draws(*(None if x is None else x[keep] for x in draws))
                tgt = {k: (x[:n_r] if k in ("rgb", "sem") else x[:n_d])
                       for k, x in tgt.items()}
            if fault == "depth_shifted" and n_depth:
                tgt["depth"] = tgt["depth"].roll(-1)
                tgt["depth_w"] = tgt["depth_w"].roll(-1)
            imp = 0.1 ** ((i - 1) / (cfg["lrate_decay"] * 1000.0))
            total, depth_total = 0.0, 0.0
            for _, p in leaves:
                p.grad = None
            n = n_r + n_d
            for lo in range(0, n, block):
                hi = min(n, lo + block)
                sub = Rays(*(x[lo:hi] for x in rays))
                dsub = Draws(*(None if x is None else x[lo:hi] for x in draws))
                out = render(params, cfg, sub, dsub, mm_dtype)
                loss, depth_part = _block_loss(cfg, out, tgt, lo, hi, n_r, n_d,
                                               imp, fault != "no_depth")
                if loss.requires_grad:  # a block of depth rays alone, term dropped
                    loss.backward()
                total += float(loss.detach())
                depth_total += depth_part
            losses.append(total)
            if n_depth and cfg["depth_loss"]:
                depth_losses.append(depth_total)
            with torch.no_grad():
                lr = lr_at(cfg, i - 1)
                bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** float(i)
                bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** float(i)
                for k, p in leaves:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    if i == 1:
                        grad_norms[k] = float(torch.linalg.norm(g))
                        grads[k] = g.detach().clone()
                    m[k] = (1 - B1) * g + B1 * m[k]
                    v[k] = (1 - B2) * (g * g) + B2 * v[k]
                    if fault == "unchanged":
                        continue
                    p.add_((m[k] / bc1.to(dev)) / (torch.sqrt(v[k] / bc2.to(dev))
                                                   + ADAM_EPS) * (-lr.to(dev)))
    change = {f"{net}.{k}": float(torch.linalg.norm(
        params[net][k].detach() - init[net][k].to(dev).float()))
        for net in params for k in params[net]}
    return Readings(losses, depth_losses, grad_norms, change, grads)


# -------------------------------------------------------------- serving ---

@torch.no_grad()
def render_frame(cfg, params, c2w, block: int = 8192, mm_dtype=None):
    """A served frame's ``rgb [H, W, 3]`` and ``disp [H, W]``: eval mode,
    no jitter, no noise, ``u`` the unit linspace."""
    H, W = cfg["H"], cfg["W"]
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    ro, rd = pixel_rays(H, W, cfg["focal"], c2w, j.reshape(-1), i.reshape(-1))
    rays = make_rays(cfg, ro, rd)
    n = ro.shape[0]
    u_row = unit_linspace(cfg["N_importance"], dev)
    rgb, disp = [], []
    with plain_float32():
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            sub = Rays(*(x[lo:hi] for x in rays))
            out = render(params, cfg, sub,
                         Draws(None, None, u_row.expand(hi - lo, -1), None),
                         mm_dtype)
            rgb.append(out["rgb"])
            disp.append(out["disp"])
    return torch.cat(rgb).reshape(H, W, 3), torch.cat(disp).reshape(H, W)


def fp8():
    """The control's precision below bfloat16."""
    return torch.float8_e4m3fn
