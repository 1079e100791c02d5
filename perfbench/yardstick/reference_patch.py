"""Plain float32 PyTorch reference of the paper's full method's training
steps: the base step of :mod:`yardstick.reference` and, on the loss
schedule's patch iterations, the losses of a rendered crop of one
training image (``run_nerf.py:1552-1721``, ``loss.py:55-133``).

A patch iteration draws, from the step's generator and before anything
else, the image, the crop's row and column and a permutation of the
crop's pixels (the program's order); the crop's pixels after the first
``gradH x gradW`` of the permutation (the no-grad leg) render first,
without gradients, in tiles of ``ng_tile`` rays, each tile drawing its
own jitter, noise and importance samples; then the base batch draws and
renders; then the first ``gradH x gradW`` pixels (the grad leg) render
under autograd. Both legs go back into the crop in scan-line order, both
passes' crops (fine, then coarse) clipped to [0, 1]. The crop's losses:

- the image-aware inverse-depth smoothness of both passes' depth crops,
  weighted by ``depth_inverse_lambda`` and the depth importance;
- the content loss: the ImageNet-normalised crops and the ground truth
  through VGG19 (``F.conv2d``, 3x3, padding 1, each followed by a ReLU,
  a 2x2 max-pool between blocks), the L1 distance of each tap weighted,
  the fine and the coarse crop each against the ground truth's taps,
  their sum weighted by ``feature_lambda``.

Departures from the published description, each the program's too: the
crop's randomness is drawn on the device (the reference draws it on the
host with numpy); the grad leg is the first ``gradH x gradW`` pixels of a
permutation (the reference draws a random subset the same way); VGG19's
weights are drawn from the seed (no ImageNet file, see the configuration's
``assumed``); the samples with transmittance below ``cull_eps`` weigh
nothing (:mod:`yardstick.reference`).

Everything runs in float32 with TF32 off. ``vgg_dtype`` rounds each VGG19
convolution's operands (the control: ``torch.bfloat16``), ``mm_dtype`` the
MLPs' as :func:`yardstick.reference.train_steps` does. A fault plants one
of the checked faults (see :func:`train_steps`). It imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from yardstick.reference import (ADAM_EPS, B1, B2, Draws, Rays, Readings,
                                 TrainData, _block_loss, _Round, batch_sizes,
                                 lr_at, make_rays, pixel_rays, plain_float32,
                                 render, step_seed)

# torchvision's VGG19 ``features``: (block, convolutions, channels).
VGG19_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 4, 256), (4, 4, 512), (5, 4, 512))
VGG19_TAPS = tuple(f"conv{b}_{i + 1}" for b, n, _ in VGG19_BLOCKS for i in range(n))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

FAULTS = ("no_feature", "no_feature0", "no_smooth", "grad_shifted",
          "unchanged", "no_depth", "half_batch")
# The faults that change the steps before a patch step.
EARLY_FAULTS = ("unchanged", "no_depth", "half_batch")
PATCH_TERMS = ("feature_loss", "feature_loss0", "inv_loss")


class PatchReadings(NamedTuple):
    readings: Readings  # grads and grad_norms: the last checked step's
    patch: Dict[str, float]  # the last patch step's terms (PATCH_TERMS)
    # The last step's VGG19 calls: (normalised NHWC input, {tap: NCHW}).
    vgg: list = []
    first: Dict[str, torch.Tensor] = {}  # each leaf's step-1 gradient


def vgg_layers(taps):
    """``(name, in_channels, out_channels, pool_before)`` of every VGG19
    convolution up to the deepest of ``taps``."""
    last = max(VGG19_TAPS.index(t) for t in taps)
    out, c_in, k = [], 3, 0
    for b, n, c in VGG19_BLOCKS:
        for i in range(n):
            if k > last:
                return out
            out.append((f"conv{b}_{i + 1}", c_in, c, i == 0 and b > 1))
            c_in, k = c, k + 1
    return out


def vgg_normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)


def vgg_features(w: Dict[str, torch.Tensor], taps, x: torch.Tensor,
                 dtype=None, calls=None) -> Dict[str, torch.Tensor]:
    """VGG19's taps (NCHW, post-ReLU) of the ImageNet-normalised NHWC
    images ``x``; ``calls`` (a list) gets the input and the taps."""
    h = x.permute(0, 3, 1, 2)
    out = {}
    for name, _, _, pool in vgg_layers(taps):
        if pool:
            h = F.max_pool2d(h, 2)
        a, k = h, w[name + ".weight"]
        if dtype is not None:
            a, k = _Round.apply(a, dtype), _Round.apply(k, dtype)
        h = torch.relu(F.conv2d(a, k, w[name + ".bias"], padding=1))
        if name in taps:
            out[name] = h
    if calls is not None:
        calls.append((x.detach(), {k: v.detach() for k, v in out.items()}))
    return out


def feature_distance(fa, fb, taps, weights, loss_type):
    total = 0.0
    for name, wt in zip(taps, weights):
        d = fa[name] - fb[name]
        total = total + (d.abs().mean() if loss_type == "l1" else (d * d).mean()) * wt
    return total


def smoothness(depth: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """``depth [B, H, W, 1]``, ``image [B, H, W, 3]``: the mean of
    ``|dx d| exp(-mean_c |dx I|)`` plus that of the same along y."""
    dxd = depth[:, :, :-1] - depth[:, :, 1:]
    dyd = depth[:, :-1] - depth[:, 1:]
    wx = torch.exp(-(image[:, :, :-1] - image[:, :, 1:]).abs().mean(-1, keepdim=True))
    wy = torch.exp(-(image[:, :-1] - image[:, 1:]).abs().mean(-1, keepdim=True))
    return (dxd * wx).abs().mean() + (dyd * wy).abs().mean()


def _clip01(x):
    # jnp.clip's minimum(maximum(x, 0), 1): a tie passes half the gradient.
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def legs(cfg):
    """``(no-grad rays, grad rays)`` of a patch step."""
    n_grad = cfg["gradH"] * cfg["gradW"]
    return cfg["nH"] * cfg["nW"] - n_grad, n_grad


def patch_on(cfg, i: int):
    """(feature on, smoothness on) at iteration ``i``: the loss schedule."""
    feat = bool(cfg.get("feature_loss") and i >= cfg["feature_start_iteration"]
                and i % cfg["feature_loss_every_n"] == 0)
    smooth = bool(cfg.get("depth_inverse_loss")
                  and i % cfg["depth_inverse_loss_every_n"] == 0)
    return feat, smooth


def _draws(cfg, g, n, dev):
    """One leg's render draws, in the program's order."""
    Sc, Sf, std = cfg["N_samples"], cfg["N_importance"], cfg["raw_noise_std"]
    t_rand = torch.rand((n, Sc), device=dev, generator=g)
    noise_c = torch.randn((n, Sc), device=dev, generator=g) * std if std > 0 else None
    u = torch.rand((n, Sf), device=dev, generator=g)
    noise_f = torch.randn((n, Sc + Sf), device=dev, generator=g) * std if std > 0 else None
    return Draws(t_rand, noise_c, u, noise_f)


def _base_batch(cfg, data: TrainData, g, n_rgb, n_depth):
    """The base step's rays, targets and draws from ``g`` (the draws of
    :func:`yardstick.reference.draw_batch`, continuing ``g``)."""
    dev = data.images.device
    V, H, W, _ = data.images.shape
    idx = torch.randint(0, V * H * W, (n_rgb,), device=dev, generator=g)
    view, pix = idx // (H * W), idx % (H * W)
    ro, rd = pixel_rays(H, W, cfg["focal"], data.poses[view],
                        (pix // W).float(), (pix % W).float())
    tgt = {"rgb": data.images.reshape(-1, 3)[idx]}
    if cfg["semantic_loss"]:
        tgt["sem"] = data.segmentation.reshape(-1)[idx].long()
    if n_depth:
        K = data.depth.shape[1]
        idx_d = torch.randint(0, V * K, (n_depth,), device=dev, generator=g)
        vd_, k = idx_d // K, idx_d % K
        xy = data.depth_coord[vd_, k]
        ro_d, rd_d = pixel_rays(H, W, cfg["focal"], data.poses[vd_], xy[:, 1], xy[:, 0])
        ro, rd = torch.cat([ro, ro_d]), torch.cat([rd, rd_d])
        tgt["depth"] = data.depth[vd_, k]
        tgt["depth_w"] = data.depth_weight[vd_, k]
    return make_rays(cfg, ro, rd), tgt, _draws(cfg, g, n_rgb + n_depth, dev)


def _render_blocks(params, cfg, rays, draws, block, mm_dtype, keys):
    outs = []
    for lo in range(0, rays.o.shape[0], block):
        hi = lo + block
        o = render(params, cfg, Rays(*(x[lo:hi] for x in rays)),
                   Draws(*(None if x is None else x[lo:hi] for x in draws)), mm_dtype)
        outs.append({k: o[k] for k in keys})
    return {k: torch.cat([o[k] for o in outs]) for k in keys}


class _Patch(NamedTuple):
    rays: Rays  # the crop's rays, scan-line order
    perm: torch.Tensor
    gt: torch.Tensor  # [nH, nW, 3]


def _draw_patch(cfg, data: TrainData, g) -> _Patch:
    dev = data.images.device
    V, H, W, _ = data.images.shape
    nH, nW = cfg["nH"], cfg["nW"]
    img = torch.randint(0, V, (1,), device=dev, generator=g)
    sh = torch.randint(0, H - nH + 1, (), device=dev, generator=g)
    sw = torch.randint(0, W - nW + 1, (), device=dev, generator=g)
    perm = torch.randperm(nH * nW, device=dev, generator=g)
    rows = (sh + torch.arange(nH, device=dev))[:, None].expand(nH, nW)
    cols = (sw + torch.arange(nW, device=dev))[None, :].expand(nH, nW)
    c2w = data.poses[img[0]]
    ro, rd = pixel_rays(H, W, cfg["focal"], c2w, rows.reshape(-1).float(),
                        cols.reshape(-1).float())
    gt = data.images[img[0]][rows, cols]
    return _Patch(make_rays(cfg, ro, rd), perm, gt)


def _assemble(vals_grad, vals_ng, perm, n_grad, shape, shift=0):
    """``[B, n_grad, C]`` and ``[B, n - n_grad, C]`` back into ``[B, nH,
    nW, C]``; ``shift`` writes the grad leg that many pixels on (a fault)."""
    B, _, C = vals_grad.shape
    n = perm.numel()
    at = perm[:n_grad] if not shift else (perm[:n_grad] + shift) % n
    full = vals_grad.new_zeros((B, n, C)).index_copy(1, at, vals_grad)
    full = full.index_copy(1, perm[n_grad:], vals_ng.detach())
    return full.reshape(B, *shape, C)


def _patch_loss(cfg, params, vgg, patch: _Patch, ng, g, imp, block, mm_dtype,
                vgg_dtype, fault, feat_on, smooth_on, calls):
    """The grad leg's render and the crop's loss terms; ``(loss, terms)``."""
    dev = patch.perm.device
    n_grad = cfg["gradH"] * cfg["gradW"]
    sel = patch.perm[:n_grad]
    rays = Rays(*(x[sel] for x in patch.rays))
    go = _render_blocks(params, cfg, rays, _draws(cfg, g, n_grad, dev), block,
                        mm_dtype, ("rgb", "rgb0", "depth", "depth0"))
    shape = (cfg["nH"], cfg["nW"])
    shift = 1 if fault == "grad_shifted" else 0

    def crop(key, clip):
        a = torch.stack([go[key], go[key + "0"]])
        b = torch.stack([ng[key], ng[key + "0"]])
        if clip:
            a, b = _clip01(a), _clip01(b)
        else:
            a, b = a[..., None], b[..., None]
        return _assemble(a, b, patch.perm, n_grad, shape, shift)

    rgb = crop("rgb", True)
    loss = rgb.new_zeros(())
    terms = {}
    if smooth_on:
        inv = smoothness(crop("depth", False), rgb)
        terms["inv_loss"] = 0.0 if fault == "no_smooth" else float(inv.detach())
        if fault != "no_smooth":
            loss = loss + inv * cfg["depth_inverse_lambda"] * imp
    if feat_on:
        taps, wts = cfg["vgg_layers"], cfg["vgg_layer_weights"]
        with torch.no_grad():
            f_gt = vgg_features(vgg, taps, vgg_normalize(patch.gt[None]), vgg_dtype,
                                calls)
        f = vgg_features(vgg, taps, vgg_normalize(rgb), vgg_dtype, calls)
        fl = feature_distance({k: v[0:1] for k, v in f.items()}, f_gt, taps, wts,
                              cfg["vgg_loss_type"])
        fl0 = feature_distance({k: v[1:2] for k, v in f.items()}, f_gt, taps, wts,
                               cfg["vgg_loss_type"])
        if fault == "no_feature0":
            fl0 = fl0 * 0.0
        total = fl + fl0
        if fault == "no_feature":
            total = total * 0.0
        terms["feature_loss"] = float(total.detach())
        terms["feature_loss0"] = float(fl0.detach()) if fault != "no_feature" else 0.0
        loss = loss + total * cfg["feature_lambda"]
    return loss, terms


class _State(NamedTuple):
    params: Dict[str, Dict[str, torch.Tensor]]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _copy(state: _State) -> _State:
    params = {net: {k: p.detach().clone().requires_grad_(True) for k, p in ps.items()}
              for net, ps in state.params.items()}
    return _State(params, {k: x.clone() for k, x in state.m.items()},
                  {k: x.clone() for k, x in state.v.items()})


def _step(cfg, data, vgg, state: _State, seed, i, block, ng_tile, mm_dtype,
          vgg_dtype, fault):
    """Step ``i`` in place on ``state``; returns ``(loss, depth term, grads,
    patch terms, VGG19 calls)``."""
    dev = data.images.device
    params = state.params
    leaves = [(f"{net}.{k}", p) for net in params for k, p in params[net].items()]
    n_rgb, n_depth = batch_sizes(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(step_seed(seed, i))
    imp = 0.1 ** ((i - 1) / (cfg["lrate_decay"] * 1000.0))
    feat_on, smooth_on = patch_on(cfg, i)
    for _, p in leaves:
        p.grad = None
    ng = patch = None
    if feat_on or smooth_on:
        patch = _draw_patch(cfg, data, g)
        n_grad = cfg["gradH"] * cfg["gradW"]
        sel = patch.perm[n_grad:]
        rays = Rays(*(x[sel] for x in patch.rays))
        parts = []
        with torch.no_grad():
            for lo in range(0, sel.numel(), ng_tile):
                hi = min(sel.numel(), lo + ng_tile)
                sub = Rays(*(x[lo:hi] for x in rays))
                parts.append(_render_blocks(params, cfg, sub, _draws(cfg, g, hi - lo, dev),
                                            block, mm_dtype, ("rgb", "rgb0", "depth", "depth0")))
        ng = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    rays, tgt, draws = _base_batch(cfg, data, g, n_rgb, n_depth)
    if fault == "half_batch":  # as yardstick.reference's
        n_rgb, n_depth, full = n_rgb // 2, n_depth // 2, n_rgb
        keep = torch.cat([torch.arange(n_rgb, device=dev),
                          full + torch.arange(n_depth, device=dev)])
        rays = Rays(*(x[keep] for x in rays))
        draws = Draws(*(None if x is None else x[keep] for x in draws))
        tgt = {k: (x[:n_rgb] if k in ("rgb", "sem") else x[:n_depth])
               for k, x in tgt.items()}
    total, depth_total = 0.0, 0.0
    n = n_rgb + n_depth
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        out = render(params, cfg, Rays(*(x[lo:hi] for x in rays)),
                     Draws(*(None if x is None else x[lo:hi] for x in draws)), mm_dtype)
        loss, depth_part = _block_loss(cfg, out, tgt, lo, hi, n_rgb, n_depth, imp,
                                       fault != "no_depth")
        if loss.requires_grad:
            loss.backward()
        total += float(loss.detach())
        depth_total += depth_part
    terms, calls = {}, []
    if patch is not None:
        loss, terms = _patch_loss(cfg, params, vgg, patch, ng, g, imp, block,
                                  mm_dtype, vgg_dtype, fault, feat_on, smooth_on,
                                  calls)
        if loss.requires_grad:
            loss.backward()
        total += float(loss.detach())
    grads = {}
    with torch.no_grad():
        lr = lr_at(cfg, i - 1).to(dev)
        bc1 = (1.0 - torch.tensor(B1, dtype=torch.float32) ** float(i)).to(dev)
        bc2 = (1.0 - torch.tensor(B2, dtype=torch.float32) ** float(i)).to(dev)
        for k, p in leaves:
            gk = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = gk.detach().clone()
            state.m[k] = (1 - B1) * gk + B1 * state.m[k]
            state.v[k] = (1 - B2) * (gk * gk) + B2 * state.v[k]
            if fault != "unchanged":
                p.add_((state.m[k] / bc1) / (torch.sqrt(state.v[k] / bc2) + ADAM_EPS) * (-lr))
    return total, depth_total, grads, terms, calls


def train_steps(cfg, data: TrainData, init, vgg: Dict[str, torch.Tensor],
                seed: int, n_steps: int, block: int, ng_tile: int,
                variants: Optional[Dict[str, dict]] = None):
    """Steps ``1..n_steps`` from the weights ``init`` (copied), VGG19's
    weights ``vgg``, each leg rendered in blocks of ``block`` rays and the
    no-grad leg drawn in tiles of ``ng_tile``. ``variants`` maps a name to
    ``{"mm_dtype", "vgg_dtype", "fault"}``; the plain reference runs as
    ``"reference"`` in any case. Faults: ``no_feature`` (both passes'
    feature terms left out, their readings 0), ``no_feature0`` (the coarse
    pass's), ``no_smooth`` (the smoothness term, its reading 0),
    ``grad_shifted`` (the grad leg's values written one pixel on in the
    crop), ``unchanged`` (the parameters never move), ``no_depth`` (the
    depth term left out, its reading 0) and ``half_batch`` (the base
    batch's terms taken over the first half of its rgb and depth rays).

    Returns ``({name: PatchReadings}, before)``, ``before`` the plain
    reference's state (parameters and Adam moments) before the last step.
    Each variant's losses, its step-1 gradient and each leaf's change come
    from its own steps. Its last step's gradient, patch terms and VGG19
    calls are taken at ``before``, so that they see that step's computation
    and not the steps before it; the program's last step is taken there too
    (``yardstick.train_patch``). Variants that change nothing before the
    last step share the plain reference's steps before it."""
    variants = dict({"reference": {}}, **(variants or {}))
    dev = data.images.device
    params = {net: {k: v.detach().float().clone().to(dev).requires_grad_(True)
                    for k, v in init[net].items()} for net in ("coarse", "fine")}
    zeros = {f"{net}.{k}": torch.zeros_like(x) for net in params
             for k, x in params[net].items()}
    fresh = _State(params, dict(zeros), {k: x.clone() for k, x in zeros.items()})
    n_rgb, n_depth = batch_sizes(cfg)
    early_patch = any(any(patch_on(cfg, i)) for i in range(1, n_steps))
    out, shared = {}, None
    with plain_float32():
        for name, kw in variants.items():
            mm, vd, fault = kw.get("mm_dtype"), kw.get("vgg_dtype"), kw.get("fault")
            late = (mm is None and fault not in EARLY_FAULTS
                    and (vd is None and fault is None or not early_patch))
            losses: List[float] = []
            depths: List[float] = []
            first_grads: Dict[str, torch.Tensor] = {}
            if late and shared is not None:
                state, losses, depths, first_grads = (
                    _copy(shared[0]), list(shared[1]), list(shared[2]), shared[3])
                first = n_steps
            else:
                state, first = _copy(fresh), 1
            for i in range(first, n_steps + 1):
                if late and i == n_steps and shared is None:
                    shared = (_copy(state), list(losses), list(depths), first_grads)
                loss, dep, grads, terms, calls = _step(cfg, data, vgg, state, seed, i,
                                                       block, ng_tile, mm, vd, fault)
                if i == 1:
                    first_grads = grads
                losses.append(loss)
                if n_depth and cfg["depth_loss"]:
                    depths.append(dep)
            change = {f"{net}.{k}": float(torch.linalg.norm(
                state.params[net][k].detach() - init[net][k].to(dev).float()))
                for net in state.params for k in state.params[net]}
            if not late:  # its last step again, from the reference's state
                _, _, grads, terms, calls = _step(cfg, data, vgg, _copy(shared[0]),
                                                  seed, n_steps, block, ng_tile, mm,
                                                  vd, fault)
            norms = {k: float(torch.linalg.norm(g)) for k, g in grads.items()}
            out[name] = PatchReadings(Readings(losses, depths, norms, change, grads),
                                      terms, calls, first_grads)
    return out, shared[0]
