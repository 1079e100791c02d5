"""Import the reference's torch ``.tar`` checkpoints into a ``TrainState``
(port of ``train/torch_import.py``).

The reference saves ``{global_step, network_fn_state_dict,
network_fine_state_dict, optimizer_state_dict[, discriminator_state_dict,
...]}`` via ``torch.save`` (``run_nerf.py:1872-1883``); so does the JAX
package's ``export_reference_checkpoint``, which is how a JAX run moves to
the port (``--ft_path``). The reference's ``NeRF`` stores ``Linear.weight``
as ``[out, in]``, as the port's modules do, so the import is a key rename
(:data:`_NERF_NAME_MAP`, the reference name of each of the port's Flax-style
layer names). The step comes from ``global_step``. The Adam moments come in
where JAX's ``import_adam_state`` takes them, from ``optimizer_state_dict``,
and stay fresh otherwise, with JAX's printed reason. With the GAN, the
reference's ``discriminator_state_dict`` loads by key into the port's
:class:`~models.discriminator.ESRDiscriminator` (same names, same NCHW
flatten order), and its moments come from ``discriminator_optimizer_dict``;
either stays fresh, with JAX's message, where it does not fit. (JAX
reorders the classifier's flattened input from the crop size halved twice
with ``// 4``, which misses the convolutions' rounding up at an odd half,
94 rows among them; so at the KITTI patch JAX keeps a fresh discriminator
where the port imports the reference's.)
"""

from __future__ import annotations

from typing import Dict, List

import torch

from depth_lidar_nerf_tpu_torch.train.state import TrainState, invalidate_packs

# Port (Flax-style) layer name -> reference torch module prefix.
_NERF_NAME_MAP = {
    "sigma": "alpha_linear",
    "feature": "feature_linear",
    "views_0": "views_linears.0",
    "rgb": "rgb_linear",
    "semantic_0": "semantic_linear.0",
    "semantic_1": "semantic_linear.1",
    "output": "output_linear",
}


def _reference_prefix(layer: str) -> str:
    if layer.startswith("trunk_"):
        return f"pts_linears.{int(layer.split('_')[1])}"
    return _NERF_NAME_MAP.get(layer)


def convert_nerf_state_dict(module, sd: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """Reference ``NeRF.state_dict()`` -> a ``state_dict`` of ``module``
    (same topology), float32, ``[out, in]`` kept."""
    out = {}
    for name, p in module.named_parameters():
        layer, kind = name.rsplit(".", 1)
        prefix = _reference_prefix(layer)
        if prefix is None or f"{prefix}.weight" not in sd:
            raise KeyError(
                f"reference state_dict is missing weights for model layer "
                f"{layer!r} (wanted {prefix!r}.weight) — keys: "
                f"{sorted(sd)[:8]}...")
        t = sd[f"{prefix}.{kind}"]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(
                f"reference layer {prefix!r} {kind} has shape "
                f"{tuple(t.shape)}, model expects {tuple(p.shape)} — check "
                "netdepth/netwidth/multires flags match the checkpoint's "
                "training config")
        out[name] = t.to(torch.float32)
    return out


def _torch_param_names(sd: Dict[str, torch.Tensor]) -> List[str]:
    """Reference ``NeRF.parameters()`` order, reconstructed from a state_dict
    (``run_nerf_helpers.py:90-110``): pts_linears, views_linears,
    feature_linear, alpha_linear, rgb_linear[, semantic_linear.{0,1}] (or
    output_linear when viewdirs are off), each Linear giving weight then
    bias."""
    names = []
    d = 0
    while f"pts_linears.{d}.weight" in sd:
        names += [f"pts_linears.{d}.weight", f"pts_linears.{d}.bias"]
        d += 1
    for prefix in ("views_linears.0", "feature_linear", "alpha_linear",
                   "rgb_linear", "output_linear", "semantic_linear.0",
                   "semantic_linear.1"):
        if f"{prefix}.weight" in sd:
            names += [f"{prefix}.weight", f"{prefix}.bias"]
    return names


def import_adam_state(optimizer, models, ckpt: Dict, step: int) -> bool:
    """Set the Adam moments of ``optimizer`` from the reference's
    ``optimizer_state_dict`` and its count to ``step`` (JAX
    ``import_adam_state``: the reference optimizes ``list(coarse.parameters())
    + list(fine.parameters())`` with one Adam, ``run_nerf.py:434-441``).
    Returns False, changing nothing, when the checkpoint has no Adam state;
    raises KeyError, ValueError or IndexError for one that does not fit."""
    opt_sd = ckpt.get("optimizer_state_dict") or {}
    if not opt_sd.get("state"):
        return False
    index_of = dict(enumerate(opt_sd["param_groups"][0]["params"]))
    moments = {}
    base = 0
    for module, key in ((models.coarse, "network_fn_state_dict"),
                        (models.fine, "network_fine_state_dict")):
        if module is None:
            continue
        sd = ckpt[key]
        names = _torch_param_names(sd)
        pos = {n: base + i for i, n in enumerate(names)}
        for name, p in module.named_parameters():
            layer, kind = name.rsplit(".", 1)
            st = opt_sd["state"][index_of[pos[f"{_reference_prefix(layer)}.{kind}"]]]
            mu, nu = st["exp_avg"], st["exp_avg_sq"]
            if tuple(mu.shape) != tuple(p.shape) or \
                    tuple(nu.shape) != tuple(p.shape):
                raise ValueError(f"Adam moments of {name} have shape "
                                 f"{tuple(mu.shape)}, the parameter "
                                 f"{tuple(p.shape)}")
            moments[p] = {"exp_avg": mu.to(p.device, torch.float32).clone(),
                          "exp_avg_sq": nu.to(p.device, torch.float32).clone()}
        base += len(names)
    optimizer.state.clear()
    for p, st in moments.items():
        optimizer.state[p] = st
    optimizer.count = int(step)
    return True


# The reference ESR discriminator's ``parameters()`` order: ``classifier`` is
# registered before ``model`` (``discriminator.py:49-55``).
_DISC_PARAM_NAMES = ["classifier.0.weight", "classifier.0.bias"] + [
    f"model.{i}.{kind}" for i in (0, 2, 4, 6) for kind in ("weight", "bias")]


def convert_discriminator_state_dict(disc, sd: Dict[str, torch.Tensor]
                                     ) -> Dict[str, torch.Tensor]:
    """The reference's ``discriminator_state_dict`` -> a ``state_dict`` of
    the port's discriminator ``disc``, float32: the same keys, each checked
    against the parameter's shape (the classifier's against the crop's)."""
    out = {}
    for name, p in disc.named_parameters():
        if name not in sd:
            raise KeyError(f"reference discriminator has no {name!r} — keys: "
                           f"{sorted(sd)[:8]}...")
        t = sd[name]
        if tuple(t.shape) != tuple(p.shape):
            if name.startswith("classifier"):
                raise ValueError(
                    f"discriminator classifier expects {p.numel()} inputs, "
                    f"checkpoint has {t.numel()} — patch nH/nW differ from "
                    "the reference run's")
            raise ValueError(f"discriminator {name} has shape "
                             f"{tuple(t.shape)}, model expects "
                             f"{tuple(p.shape)}")
        out[name] = t.to(torch.float32)
    return out


def import_disc_adam_state(optimizer, disc, ckpt: Dict, step: int) -> bool:
    """Set the discriminator's Adam moments from the reference's
    ``discriminator_optimizer_dict`` (JAX ``import_disc_adam_state``) by
    the reference's parameter order, and its count to ``step``. Returns
    False, changing nothing, when the checkpoint has no such state."""
    opt_sd = ckpt.get("discriminator_optimizer_dict") or {}
    if not opt_sd.get("state"):
        return False
    index_of = dict(enumerate(opt_sd["param_groups"][0]["params"]))
    pos = {n: i for i, n in enumerate(_DISC_PARAM_NAMES)}
    moments = {}
    for name, p in disc.named_parameters():
        st = opt_sd["state"][index_of[pos[name]]]
        mu, nu = st["exp_avg"], st["exp_avg_sq"]
        if tuple(mu.shape) != tuple(p.shape) or \
                tuple(nu.shape) != tuple(p.shape):
            raise ValueError(f"Adam moments of discriminator {name} have "
                             f"shape {tuple(mu.shape)}, the parameter "
                             f"{tuple(p.shape)}")
        moments[p] = {"exp_avg": mu.to(p.device, torch.float32).clone(),
                      "exp_avg_sq": nu.to(p.device, torch.float32).clone()}
    optimizer.state.clear()
    for p, st in moments.items():
        optimizer.state[p] = st
    optimizer.count = int(step)
    return True


def import_reference_checkpoint(ckpt: Dict, state: TrainState, *,
                                load_optimizer: bool = True,
                                source: str = "checkpoint",
                                verbose: bool = True) -> TrainState:
    """Load a reference ``.tar`` checkpoint (read by
    ``checkpoint.load_file``) into ``state``: coarse and fine weights, the
    step, with ``load_optimizer`` the Adam moments where they fit, and where
    both the run and the checkpoint have one, the discriminator (and with
    ``load_optimizer`` its moments)."""
    models = state.models
    coarse = convert_nerf_state_dict(models.coarse,
                                     ckpt["network_fn_state_dict"])
    fine = None
    if models.fine is not None:
        fine_sd = ckpt.get("network_fine_state_dict")
        if fine_sd is None:
            raise KeyError("model has a fine network but the checkpoint has "
                           "no network_fine_state_dict")
        fine = convert_nerf_state_dict(models.fine, fine_sd)
    models.coarse.load_state_dict(coarse)
    if fine is not None:
        models.fine.load_state_dict(fine)
    moved = ["params"]
    step = int(ckpt.get("global_step", 0))

    disc, disc_sd = models.discriminator, ckpt.get("discriminator_state_dict")
    disc_in = False
    if disc is not None and disc_sd is not None:
        try:
            disc.load_state_dict(convert_discriminator_state_dict(disc,
                                                                  disc_sd))
            moved.append("disc_params")
            disc_in = True
        except (KeyError, ValueError) as e:
            if verbose:
                print(f"discriminator not imported ({e}); keeping fresh init")
    if load_optimizer:
        try:
            if import_adam_state(state.optimizer, models, ckpt, step):
                moved.append("opt_state")
        except (KeyError, ValueError, IndexError) as e:
            if verbose:
                print(f"optimizer moments not imported ({e}); keeping fresh "
                      "init (--no_reload_optimizer semantics)")
    if load_optimizer and disc_in:
        try:
            if import_disc_adam_state(state.disc_optimizer, disc, ckpt, step):
                moved.append("disc_opt_state")
        except (KeyError, ValueError, IndexError) as e:
            if verbose:
                print(f"discriminator moments not imported ({e}); keeping "
                      "fresh init")
    state.step = step
    invalidate_packs(models)
    if verbose:
        print(f"imported reference checkpoint {source} (step {step}; "
              f"{', '.join(sorted(moved))})")
    return state
