"""The volumetric renderer (port of ``render/renderer.py``: serving, and the
training step's differentiated render).

``render_image`` -> ``render_rays_tiled`` -> ``render_rays`` ->
``_composite_from_z``, as in the JAX package, and the serving modes that
compose with it: int8 (``render_int8``), fine-only (``render_fine_only``),
coarse-downsampled frames (``render_image_coarse_downsampled``) and the
baked density grid (``render_grid``; ``ops/density_grid.py``). Where JAX
compiles the tile loop into one ``lax.map``, the port runs a Python loop over
ray tiles: PyTorch is eager, and each tile's work is a few large kernel
launches. The modules own their weights, so the JAX functions' ``params``
argument is gone; the baked grid, which JAX carries in
``params["density_grid"]``, is the ``density_grid`` argument here.

Ray parametrization parity (``run_nerf.py:112-194``): rays carry origin,
direction, near, far and the unit *pre-NDC* view direction.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import torch

from depth_lidar_nerf_tpu_torch.device import resolve_device
from depth_lidar_nerf_tpu_torch.ops.compositing import (RayOutputs,
                                                        composit_dists,
                                                        raw2outputs,
                                                        raw2outputs_t)
from depth_lidar_nerf_tpu_torch.ops.density_grid import trilinear_sigma
from depth_lidar_nerf_tpu_torch.ops.embedding import positional_encoding
from depth_lidar_nerf_tpu_torch.ops.fused_mlp_t import supports_rays_shape
from depth_lidar_nerf_tpu_torch.ops.rays import (camera_rays, ndc_rays,
                                                 rays_by_coord)
from depth_lidar_nerf_tpu_torch.ops.sampling import (base_generator,
                                                     batch_rows, draw_rows,
                                                     sample_pdf,
                                                     stratified_z_vals,
                                                     unit_linspace)
from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import sample_pdf_cuda
from depth_lidar_nerf_tpu_torch.parallel.gather import run_sharded
from depth_lidar_nerf_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static rendering hyperparameters (config_parser flags, run_nerf.py:693-747)."""

    N_samples: int = 64
    N_importance: int = 64
    perturb: bool = True
    lindisp: bool = False
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    num_semantic_classes: int = 0
    ndc: bool = True
    near: float = 0.0
    far: float = 1.0
    # On the card, inverse-CDF sampling always runs the CUDA kernel
    # (csrc/sample_pdf.cu). On the CPU the flag (the JAX package's name)
    # picks the kernel's plain twin over the dense ``ops.sampling.sample_pdf``.
    use_pallas_sampling: bool = False
    # run_nerf.py:77-89 ``--chunk``/``--netchunk``: ``chunk`` bounds rays per
    # render tile; ``netchunk`` bounds points per plain-MLP apply.
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64
    # Samples whose incoming transmittance is below cull_eps get exactly zero
    # weight (no reference counterpart); 0.0 = strict reference math.
    cull_eps: float = 0.0
    # Serving modes, eval renders only (no reference counterpart; the
    # training RenderConfig never sets them, ``train.config.
    # eval_render_config`` does). ``render_int8``: the W8A8 forwards
    # (kernels 10 and 11; no backward). ``render_fine_only``: the fine pass
    # evaluates only the N_importance samples the coarse pass placed, not
    # the stratified + importance union. ``render_coarse_downsample`` k > 1:
    # ``render_image`` runs the coarse pass at (H/k, W/k), one ray per k x k
    # pixel block, shares its sample depths across the block and renders
    # the fine-only pass at full resolution; 0/1 = off.
    render_int8: bool = False
    render_fine_only: bool = False
    render_coarse_downsample: int = 0
    # Baked-density-grid serving, given a ``density_grid`` (eval renders
    # only): ``render_grid`` R > 0 replaces the coarse MLP pass by a
    # trilinear lookup of the R^3 sigma grid; ``render_grid_fine_only``: the
    # fine pass evaluates only the grid-placed samples;
    # ``render_grid_samples``: the grid CDF's stratified count (0 =
    # N_samples).
    render_grid: int = 0
    render_grid_fine_only: bool = False
    render_grid_samples: int = 0

    def render_tile(self, fused: bool = False) -> int:
        """Rays per tile. The fused kernel keeps every activation in shared
        memory, so only ``chunk`` binds it; the plain path materialises
        ``[points, W]`` activations and also honours a lowered ``netchunk``."""
        s_total = max(1, self.N_samples + self.N_importance)
        by_points = max(128, self.netchunk // s_total)
        if not fused and self.netchunk < 1024 * 64:
            return max(128, min(self.chunk, by_points))
        return max(128, self.chunk)

    def eval_mode(self) -> "RenderConfig":
        """Test-time variant: no jitter, no sigma noise (run_nerf.py:502-504)."""
        return dataclasses.replace(self, perturb=False, raw_noise_std=0.0)


class Rays(NamedTuple):
    origins: torch.Tensor  # [N, 3] (possibly NDC-warped)
    directions: torch.Tensor  # [N, 3] (possibly NDC-warped)
    viewdirs: Optional[torch.Tensor]  # [N, 3] unit, pre-NDC; None w/o viewdirs
    near: torch.Tensor  # [N, 1]
    far: torch.Tensor  # [N, 1]


def make_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, cfg: RenderConfig,
              H: int | None = None, W: int | None = None, focal=None) -> Rays:
    """Package world-space rays: viewdirs from the pre-NDC directions, then
    the NDC warp (``run_nerf.py:145-183``)."""
    rays_o = rays_o.reshape(-1, 3).float()
    rays_d = rays_d.reshape(-1, 3).float()
    viewdirs = None
    if cfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if cfg.ndc:
        if H is None or W is None or focal is None:
            raise ValueError("ndc=True requires H, W and focal in make_rays()")
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    near = torch.full_like(rays_d[..., :1], cfg.near)
    far = torch.full_like(rays_d[..., :1], cfg.far)
    return Rays(rays_o, rays_d, viewdirs, near, far)


def query_network(model, pts, viewdirs, cfg: RenderConfig) -> torch.Tensor:
    """Encode and evaluate the field at ``pts [N, S, 3]``: through the
    packed-lane kernels 12 and 13 (``model.apply_raw``) on JAX's predicate
    (``render/renderer.py`` ``query_network``: ``[N, S, 3]`` points with S
    dividing 1,024, view directions, and a model that ``supports_raw``),
    else the plain module. A frozen-alpha model is a plain module that puts
    its alpha model's density in place of its own."""
    if (hasattr(model, "supports_raw") and pts.dim() == 3
            and pts.shape[-2] > 0 and 1024 % pts.shape[-2] == 0
            and viewdirs is not None and model.supports_raw(cfg)):
        return model.apply_raw(pts, viewdirs, cfg)
    dtype = getattr(model, "dtype", torch.float32)
    pts_embed = positional_encoding(pts, cfg.multires).to(dtype)
    views_embed = None
    if cfg.use_viewdirs:
        ve = positional_encoding(viewdirs, cfg.multires_views)
        views_embed = ve[..., None, :].expand(
            pts.shape[:-1] + ve.shape[-1:]).to(dtype)
    return model(pts_embed, views_embed)


def _fused_ok(model, cfg: RenderConfig, S: int) -> bool:
    """The predicate that picks the fused kernels (kernel 1, or kernel 10
    with ``render_int8``) for one RGB pass, as JAX's: S divides the 2,048-point
    JAX tile into at most 128 rays, and the topology is covered."""
    return (cfg.use_viewdirs and cfg.num_semantic_classes == 0
            and supports_rays_shape(S) and hasattr(model, "apply_rays")
            and model.supports_rays_path(cfg))


def _int8_semantic(model, cfg: RenderConfig) -> bool:
    return cfg.render_int8 and hasattr(model, "apply_rays_semantic_q8")


def _semantic_ok(model, cfg: RenderConfig, n_rays: int, S: int) -> bool:
    """The predicate that picks the semantic kernels for one pass of
    ``n_rays`` rays (JAX ``_composite_from_z``'s semantic arm): a model with
    a semantic head within the saved-activation cap, which applies to
    passes without a gradient too; the int8 pass saves no activations, so
    it is checked with no points (``n_points=0``), as in JAX."""
    n_points = 0 if _int8_semantic(model, cfg) else n_rays * S
    return (cfg.num_semantic_classes > 0 and cfg.use_viewdirs
            and hasattr(model, "apply_rays_semantic")
            and supports_rays_shape(S)
            and model.supports_raw_semantic(cfg, n_points=n_points, S=S))


def _sigma_noise(z_vals, cfg: RenderConfig, generator):
    if cfg.raw_noise_std > 0.0 and base_generator(generator) is not None:
        return draw_rows(z_vals.shape, generator, normal=True,
                         device=z_vals.device) * cfg.raw_noise_std
    return None


def _composite_from_z(model, rays: Rays, z_vals, cfg: RenderConfig,
                      generator, save_acts: bool = False,
                      fwd_sort_key=None) -> RayOutputs:
    """Evaluate the field at per-ray depths and composite: the fused kernels
    and the channel-major compositor where the topology is covered (the
    semantic kernels for a model with a semantic head, whose logits come
    already summed over each ray's samples), else the plain module and the
    standard compositor. With ``render_int8`` the covered passes take the
    int8 kernels (11 for a semantic pass, else 10), in JAX's order.
    ``save_acts`` asks a differentiated fused pass to save its activations
    for the backward. ``fwd_sort_key [N]`` (each ray's estimated
    termination depth) with ``cull_eps > 0`` hands the fused RGB pass what
    the early-terminating forward needs (JAX ``fwd_cull``): the key, the
    compositor's distance terms and the one sigma noise tensor that the
    compositor also adds. Given a :class:`~ops.sampling.RowRange` for its
    generator (a rank's shard of a batch), the semantic kernels' cap is
    checked at the whole batch's ray count, so that a shard takes the
    route that the batch takes in one process."""
    S = z_vals.shape[-1]
    if rays.viewdirs is not None and _semantic_ok(
            model, cfg, batch_rows(generator, z_vals.shape[0]), S):
        noise = _sigma_noise(z_vals, cfg, generator)
        if _int8_semantic(model, cfg):
            raw_t, sem_map = model.apply_rays_semantic_q8(rays, z_vals, cfg)
        else:
            raw_t, sem_map = model.apply_rays_semantic(rays, z_vals, cfg)
        out = raw2outputs_t(
            raw_t, z_vals, rays.directions, raw_noise_std=cfg.raw_noise_std,
            white_bkgd=cfg.white_bkgd, generator=generator,
            cull_eps=cfg.cull_eps, noise=noise)
        return out._replace(semantic=sem_map)
    if (cfg.render_int8 and rays.viewdirs is not None
            and hasattr(model, "apply_rays_q8") and _fused_ok(model, cfg, S)):
        raw_t = model.apply_rays_q8(rays, z_vals, cfg)
        return raw2outputs_t(
            raw_t, z_vals, rays.directions, raw_noise_std=cfg.raw_noise_std,
            white_bkgd=cfg.white_bkgd, generator=generator,
            cull_eps=cfg.cull_eps)
    if rays.viewdirs is not None and _fused_ok(model, cfg, S):
        noise = _sigma_noise(z_vals, cfg, generator)
        fwd_cull = None
        if fwd_sort_key is not None and cfg.cull_eps > 0.0:
            fwd_cull = (fwd_sort_key.detach(),
                        composit_dists(z_vals, rays.directions),
                        noise if noise is not None
                        else torch.zeros_like(z_vals, dtype=torch.float32),
                        cfg.cull_eps)
        raw_t = model.apply_rays(rays, z_vals, cfg, save_acts=save_acts,
                                 fwd_cull=fwd_cull)
        return raw2outputs_t(
            raw_t, z_vals, rays.directions, raw_noise_std=cfg.raw_noise_std,
            white_bkgd=cfg.white_bkgd, generator=generator,
            cull_eps=cfg.cull_eps, noise=noise)
    pts = (rays.origins[..., None, :]
           + rays.directions[..., None, :] * z_vals[..., :, None])
    raw = query_network(model, pts, rays.viewdirs, cfg)
    return raw2outputs(
        raw, z_vals, rays.directions, raw_noise_std=cfg.raw_noise_std,
        white_bkgd=cfg.white_bkgd, generator=generator,
        num_semantic_classes=cfg.num_semantic_classes, cull_eps=cfg.cull_eps)


def _composite_from_grid(grid3, rays: Rays, z_vals,
                         cfg: RenderConfig) -> RayOutputs:
    """The coarse pass of grid serving (JAX ``_composite_from_grid``): raw
    sigma by trilinear lookup of the baked grid ``grid3 = (grid, lo, hi)``
    at the samples, composited by the standard math so that its weights
    place the fine samples as a coarse MLP pass would. Its RGB is a
    constant raw -20 (black): the fine pass paints the image. No noise."""
    grid, lo, hi = grid3
    pts = (rays.origins[..., None, :]
           + rays.directions[..., None, :] * z_vals[..., :, None])
    sigma = trilinear_sigma(grid, lo, hi, pts)  # [N, S] raw
    raw_t = torch.cat([torch.full((3,) + sigma.shape, -20.0,
                                  dtype=torch.float32, device=sigma.device),
                       sigma[None]], dim=0)
    return raw2outputs_t(raw_t, z_vals, rays.directions,
                         white_bkgd=cfg.white_bkgd, cull_eps=cfg.cull_eps)


def _serving_grid(cfg: RenderConfig, density_grid):
    """The grid a render uses: JAX's rule, ``render_grid > 0`` and a fine
    pass to paint the image."""
    if cfg.render_grid > 0 and cfg.N_importance > 0:
        return density_grid
    return None


def fused_eval_ready(model, fine_model, cfg: RenderConfig,
                     tile: int | None = None, density_grid=None) -> bool:
    """True when every pass of a ``tile``-ray render (``chunk`` rays by
    default) takes the fused kernels, so ``netchunk`` need not shrink the
    ray tile. A semantic pass is checked at the tile's point count (none
    with ``render_int8``); with ``render_fine_only`` the fine pass has
    ``N_importance`` samples. Grid serving runs no coarse MLP, so only its
    fine pass gates the tile (and with ``render_grid_fine_only`` it has
    ``N_importance`` samples)."""
    if tile is None:
        tile = cfg.render_tile(fused=True)
    grid = _serving_grid(cfg, density_grid) is not None

    def pass_ok(m, S):
        if cfg.num_semantic_classes > 0:
            return _semantic_ok(m, cfg, tile, S)
        return _fused_ok(m, cfg, S)

    if not grid and not pass_ok(model, cfg.N_samples):
        return False
    if cfg.N_importance > 0:
        fm = fine_model if fine_model is not None else model
        fine_only = cfg.render_fine_only or (grid and cfg.render_grid_fine_only)
        return pass_ok(fm, cfg.N_importance if fine_only
                       else cfg.N_samples + cfg.N_importance)
    return True


def render_rays(model, fine_model, rays: Rays, cfg: RenderConfig,
                generator: torch.Generator | None = None,
                density_grid=None) -> Dict[str, torch.Tensor]:
    """Coarse + hierarchical-fine volumetric rendering of a ray batch.

    Returns the reference's result dictionary (``run_nerf.py:648-663``): the
    fine pass's ``rgb_map/disp_map/acc_map/depth_map/weights``, the coarse
    ``rgb0/disp0/acc0/depth_map0``, ``z_std``, and with a semantic head the
    ray-summed logits ``sem_preds`` (fine) and ``sem_preds0`` (coarse). ``generator`` drives the
    stratified jitter, sigma noise and random importance draws, in that order.
    Under autograd the coarse pass takes the recompute backward (or, under
    ``DLNERF_ACTS_COARSE=1``, read at call time, saves its activations) and
    the fine pass saves its activations (the JAX ``render_rays``); a
    semantic pass always saves them. With ``cull_eps > 0`` and
    ``DLNERF_CULL_FWD=1`` the fine pass takes the early-terminating forward
    (kernel 9), sorted by the coarse pass's termination estimate. With ``render_fine_only`` the fine
    pass evaluates only the sorted importance samples.

    ``density_grid = (grid, lo, hi)`` (``ops.density_grid.
    bake_density_grid``) with ``render_grid > 0`` and a fine pass replaces
    the coarse MLP pass by :func:`_composite_from_grid` on
    ``render_grid_samples`` (or ``N_samples``) stratified depths; with
    ``render_grid_fine_only`` the fine pass evaluates only the importance
    samples. A semantic fine pass then gets zero ``sem_preds0``.
    """
    grid = _serving_grid(cfg, density_grid)
    n_strat = (cfg.render_grid_samples or cfg.N_samples) if grid is not None \
        else cfg.N_samples
    z_vals = stratified_z_vals(rays.near, rays.far, n_strat,
                               lindisp=cfg.lindisp, perturb=cfg.perturb,
                               generator=generator)
    if grid is not None:
        coarse = _composite_from_grid(grid, rays, z_vals, cfg)
    else:
        coarse = _composite_from_z(
            model, rays, z_vals, cfg, generator,
            save_acts=os.environ.get("DLNERF_ACTS_COARSE", "0") == "1")
    ret = {"rgb_map": coarse.rgb, "disp_map": coarse.disp,
           "acc_map": coarse.acc, "depth_map": coarse.depth,
           "weights": coarse.weights}
    if coarse.semantic is not None:
        ret["sem_preds"] = coarse.semantic

    if cfg.N_importance > 0:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        sampler = (sample_pdf_cuda if cfg.use_pallas_sampling
                   or z_mid.device.type == "cuda" else sample_pdf)
        # No gradient flows through the samples (JAX stop_gradient), and the
        # kernel reads its inputs' memory, so they leave the graph first.
        z_samples = sampler(z_mid.detach(), coarse.weights[..., 1:-1].detach(),
                            cfg.N_importance, det=not cfg.perturb,
                            generator=generator)
        if cfg.render_fine_only or (grid is not None
                                    and cfg.render_grid_fine_only):
            z_all = torch.sort(z_samples, dim=-1).values
        else:
            z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                               dim=-1).values
        # The early-terminating forward's sort key: the coarse pass's
        # expected termination depth, unterminated (low-acc) rays last. Only
        # an ordering heuristic; exactness never depends on it.
        fine_key = None
        if cfg.cull_eps > 0.0:
            fine_key = (coarse.depth + (1.0 - coarse.acc) * 1e6).detach()
        fine = _composite_from_z(
            fine_model if fine_model is not None else model, rays, z_all,
            cfg, generator, save_acts=True, fwd_sort_key=fine_key)
        ret.update({
            "rgb0": coarse.rgb, "disp0": coarse.disp, "acc0": coarse.acc,
            "depth_map0": coarse.depth,
            "rgb_map": fine.rgb, "disp_map": fine.disp, "acc_map": fine.acc,
            "depth_map": fine.depth, "weights": fine.weights,
            "z_std": torch.std(z_samples, dim=-1, correction=0),
        })
        if fine.semantic is not None:
            # The grid's coarse pass has no semantic head: a zero stand-in.
            ret["sem_preds0"] = (coarse.semantic if coarse.semantic is not None
                                 else torch.zeros_like(fine.semantic))
            ret["sem_preds"] = fine.semantic
    return ret


def pick_render_tile(model, fine_model, cfg: RenderConfig, n: int,
                     density_grid=None, fused_cap: int | None = None,
                     flax_cap: int | None = None) -> int:
    """Ray-tile policy of :func:`render_rays_tiled` (JAX
    ``pick_render_tile``): ``chunk`` rays (at most ``n``, and at most
    ``fused_cap``) when every pass of a tile that size is fused, else the
    ``netchunk``-honouring tile, at most ``flax_cap``. The training step's
    no-grad patch leg passes the caps."""
    fused_tile = min(cfg.render_tile(fused=True), max(n, 1))
    if fused_cap is not None:
        fused_tile = min(fused_tile, fused_cap)
    if fused_eval_ready(model, fine_model, cfg, fused_tile, density_grid):
        return fused_tile
    tile = cfg.render_tile()
    return tile if flax_cap is None else min(tile, flax_cap)


def _rows(rays: Rays, lo: int, hi: int) -> Rays:
    return Rays(*(None if x is None else x[lo:hi] for x in rays))


def render_rays_tiled(model, fine_model, rays: Rays, cfg: RenderConfig,
                      generator: torch.Generator | None = None,
                      tile: int | None = None, density_grid=None, mesh=None,
                      tile_span: str = "frame.tile") -> Dict[str, torch.Tensor]:
    """Render a large ray batch in tiles of ``tile`` rays (``chunk`` by
    default); the last tile is ragged. Per-ray results do not depend on the
    tiling when ``generator`` is None.

    With a ``mesh`` (:class:`~parallel.mesh.RayMesh`) each tile is split
    over the ranks, each rank renders its rows (drawing for the whole tile,
    :func:`~parallel.gather.run_sharded`), and the tile's per-ray outputs
    are gathered, every key but the ``[N, S]`` ``weights``. The kernels
    work ray by ray, so the outputs equal one process's. Each tile is a
    ``tile_span`` span (``utils.tracing``; ``frame.tile`` unless the caller
    names another), its id the tile's index."""
    n = rays.origins.shape[0]
    if tile is None:
        tile = pick_render_tile(model, fine_model, cfg, n, density_grid)
    tile = max(1, min(tile, n))
    outs = []
    for t, s in enumerate(range(0, n, tile)):
        sub = _rows(rays, s, s + tile)
        with span(tile_span, t):
            if mesh is None:
                out = render_rays(model, fine_model, sub, cfg, generator,
                                  density_grid)
            else:
                out = run_sharded(
                    mesh, sub.origins.shape[0], lambda lo, hi, g: {
                        k: v for k, v in render_rays(
                            model, fine_model, _rows(sub, lo, hi), cfg, g,
                            density_grid).items() if k != "weights"},
                    generator)
        outs.append(out)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


@torch.no_grad()
def render_image(model, fine_model, H: int, W: int, focal, c2w,
                 cfg: RenderConfig, tile: int | None = None,
                 device=None, density_grid=None,
                 mesh=None) -> Dict[str, torch.Tensor]:
    """Render a full image pose on ``device`` (``cuda`` unless given):
    ``render(..., c2w=...)`` plus chunking (``run_nerf.py:138-189``). With
    ``render_coarse_downsample`` k > 1, a fine pass, k dividing H and W and
    no ``density_grid``, the frame is
    :func:`render_image_coarse_downsampled`'s. With a ``mesh`` the frame's
    rays are split over the ranks (:func:`render_rays_tiled`) and every
    rank gets the whole frame, without ``weights``. Making the rays is a
    ``frame.rays`` span (``utils.tracing``)."""
    k = cfg.render_coarse_downsample
    if (k > 1 and cfg.N_importance > 0 and H % k == 0 and W % k == 0
            and density_grid is None):
        return render_image_coarse_downsampled(model, fine_model, H, W, focal,
                                               c2w, cfg, tile, device, mesh)
    device = resolve_device(device)
    with span("frame.rays"):
        c2w = torch.as_tensor(c2w, dtype=torch.float32,
                              device=device)[:3, :4]
        rays_o, rays_d = camera_rays(H, W, focal, c2w)
        rays = make_rays(rays_o, rays_d, cfg, H, W, focal)
    out = render_rays_tiled(model, fine_model, rays, cfg.eval_mode(),
                            generator=None, tile=tile,
                            density_grid=density_grid, mesh=mesh)
    return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()}


@torch.no_grad()
def render_image_coarse_downsampled(model, fine_model, H: int, W: int, focal,
                                    c2w, cfg: RenderConfig,
                                    tile: int | None = None,
                                    device=None,
                                    mesh=None) -> Dict[str, torch.Tensor]:
    """Serving with ``render_coarse_downsample = k`` (JAX
    ``render_image_coarse_downsampled``): the coarse pass at ``(H/k, W/k)``,
    one ray through the centre of each k x k pixel block, untiled;
    deterministic inverse-CDF sampling (kernel 14 on the card); the sorted
    sample depths shared by the block; a full-resolution fine-only pass in
    ``tile``-ray tiles (picked as for a ``render_fine_only`` frame). Returns
    the fine ``rgb_map``/``disp_map``/``acc_map``/``depth_map`` (and
    ``sem_preds``) and the coarse ``rgb0``/``depth_map0``/``acc0`` upsampled
    to full resolution. With a ``mesh`` the coarse rays and each fine tile
    are split over the ranks and gathered, as in :func:`render_rays_tiled`."""
    k = cfg.render_coarse_downsample
    if k <= 1 or cfg.N_importance <= 0 or H % k or W % k:
        raise ValueError(
            f"render_coarse_downsample={k} needs k>1, N_importance>0 and "
            f"k | H,W (H={H}, W={W})")
    device = resolve_device(device)
    cfg = cfg.eval_mode()
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)[:3, :4]
    Hd, Wd = H // k, W // k
    if tile is None:
        tile = pick_render_tile(model, fine_model,
                                dataclasses.replace(cfg, render_fine_only=True),
                                H * W)
    tile = max(1, min(tile, H * W))

    jj, ii = torch.meshgrid(torch.arange(Hd, dtype=torch.float32, device=device),
                            torch.arange(Wd, dtype=torch.float32, device=device),
                            indexing="ij")
    coords = torch.stack([ii * k + (k - 1) * 0.5, jj * k + (k - 1) * 0.5],
                         dim=-1).reshape(-1, 2)
    ro, rd = rays_by_coord(H, W, focal, c2w, coords)
    rays_lo = make_rays(ro, rd, cfg, H, W, focal)
    sampler = sample_pdf_cuda if device.type == "cuda" else sample_pdf

    def coarse_pass(lo, hi, gen):
        sub = _rows(rays_lo, lo, hi)
        z_lo = stratified_z_vals(sub.near, sub.far, cfg.N_samples,
                                 lindisp=cfg.lindisp, perturb=False)
        c = _composite_from_z(model, sub, z_lo, cfg, gen)
        z_mid = 0.5 * (z_lo[..., 1:] + z_lo[..., :-1])
        z = torch.sort(sampler(z_mid, c.weights[..., 1:-1], cfg.N_importance,
                               det=True), dim=-1).values
        return {"rgb": c.rgb, "depth": c.depth, "acc": c.acc, "z": z}

    coarse = run_sharded(mesh, Hd * Wd, coarse_pass)
    z_samples = coarse["z"]

    def up(a):  # [Hd * Wd, ...] -> [H, W, ...], each value over its block
        a = a.reshape((Hd, Wd) + a.shape[1:])
        return a.repeat_interleave(k, dim=0).repeat_interleave(k, dim=1)

    z_full = up(z_samples).reshape(H * W, -1)
    rays_o, rays_d = camera_rays(H, W, focal, c2w)
    rays = make_rays(rays_o, rays_d, cfg, H, W, focal)
    fm = fine_model if fine_model is not None else model
    outs = []
    for s in range(0, H * W, tile):
        sub, z_tile = _rows(rays, s, s + tile), z_full[s:s + tile]

        def fine_pass(lo, hi, gen):
            fine = _composite_from_z(fm, _rows(sub, lo, hi), z_tile[lo:hi],
                                     cfg, gen)
            o = {"rgb_map": fine.rgb, "disp_map": fine.disp,
                 "acc_map": fine.acc, "depth_map": fine.depth}
            if fine.semantic is not None:
                o["sem_preds"] = fine.semantic
            return o

        outs.append(run_sharded(mesh, z_tile.shape[0], fine_pass))
    out = {key: torch.cat([o[key] for o in outs]).reshape(
        (H, W) + outs[0][key].shape[1:]) for key in outs[0]}
    out.update({"rgb0": up(coarse["rgb"]), "depth_map0": up(coarse["depth"]),
                "acc0": up(coarse["acc"])})
    return out


def sample_sigma(model, rays: Rays, z_vals, cfg: RenderConfig):
    """Query the field at explicit depths ``z_vals [N, S]`` (JAX
    ``sample_sigma``; the reference's ``sample_sigma``,
    ``run_nerf_helpers.py:598-611``): returns (rgb ``[N, S, 3]``, sigma
    ``[N, S]``, the composited :class:`RayOutputs`). The probing API of
    depth-ray diagnostics; its raw query takes kernels 12 and 13 where
    :func:`query_network` routes it there."""
    pts = (rays.origins[..., None, :]
           + rays.directions[..., None, :] * z_vals[..., :, None])
    raw = query_network(model, pts, rays.viewdirs, cfg).float()
    rgb = torch.sigmoid(raw[..., :3])
    sigma = torch.relu(raw[..., 3])
    outs = raw2outputs(raw, z_vals, rays.directions,
                       num_semantic_classes=cfg.num_semantic_classes)
    return rgb, sigma, outs


def render_test_ray(model, rays: Rays, cfg: RenderConfig):
    """Uniform near -> far probe along given rays (JAX ``render_test_ray``,
    ``run_nerf.py:361-386``): (rgb, sigma, z_vals, depth)."""
    t = unit_linspace(cfg.N_samples, rays.near.device)
    z_vals = rays.near * (1.0 - t) + rays.far * t
    rgb, sigma, outs = sample_sigma(model, rays, z_vals, cfg)
    return rgb, sigma, z_vals, outs.depth
