"""Weights from the JAX package's Flax pytrees.

Flax ``Dense`` stores ``kernel [in, out]`` and ``bias [out]`` under the layer
name (``models/nerf_mlp.py:50-81``); ``nn.Linear`` stores ``weight [out, in]``.
Flax ``Conv`` stores ``kernel [kh, kw, in, out]`` (HWIO); ``nn.Conv2d`` stores
``weight [out, in, kh, kw]`` (OIHW).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from depth_lidar_nerf_tpu_torch.models.discriminator import feature_hw
from depth_lidar_nerf_tpu_torch.parallel.mesh import shard_rows


def mlp_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One MLP's Flax params (with or without the ``params`` level) -> a
    :class:`~models.nerf_mlp.NeRFMLP` state dict, float32."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for name, layer in p.items():
        kernel = np.asarray(layer["kernel"], dtype=np.float32)
        out[f"{name}.weight"] = torch.from_numpy(
            np.array(kernel.T, dtype=np.float32, order="C"))
        out[f"{name}.bias"] = torch.from_numpy(
            np.array(layer["bias"], dtype=np.float32))
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"coarse": flax, "fine": flax or None}`` (numpy leaves) -> the same
    keys mapped to state dicts; load each with ``module.load_state_dict``."""
    return {k: (None if v is None else mlp_state_dict(v))
            for k, v in tree.items()}


def shard_mlp_state_dict(sd: Mapping[str, torch.Tensor], tp: int,
                         tp_rank: int) -> Dict[str, torch.Tensor]:
    """One process's MLP state dict (or a dict of tensors shaped as its
    entries, such as their Adam moments) -> model rank ``tp_rank``'s of a
    ``tp``-way split: the rows of each entry that
    :func:`~parallel.mesh.tp_spec` splits, every other entry whole (JAX
    ``shard_params``; load it into a
    :class:`~models.nerf_mlp.ColumnParallelNeRFMLP`)."""
    return {k: shard_rows(v, tp, tp_rank) for k, v in sd.items()}


def gather_mlp_state_dict(shards: Sequence[Mapping[str, torch.Tensor]],
                          full_shapes: Mapping[str, Sequence[int]]
                          ) -> Dict[str, torch.Tensor]:
    """The model ranks' :func:`shard_mlp_state_dict` parts, in rank order ->
    one process's state dict: an entry whose part is smaller than its
    ``full_shapes`` entry is the parts stacked; any other is held whole by
    every rank, which computes it alike, and must be the same in every part
    (``RuntimeError`` if the ranks drifted apart)."""
    out = {}
    for k, v in shards[0].items():
        if tuple(v.shape) != tuple(full_shapes[k]):
            out[k] = torch.cat([s[k] for s in shards])
        elif all(torch.equal(v, s[k]) for s in shards[1:]):
            out[k] = v
        else:
            raise RuntimeError(
                f"{k}: held whole on every model rank, but the ranks' copies "
                "differ")
    return out


def conv_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax tree of ``Conv`` layers, nested by module name (the frozen
    perceptual models: ``VGG19Features``, ``LPIPS`` with its ``backbone``
    and ``lin_*`` heads, SqueezeNet's ``fire_*`` modules), with or without
    the ``params`` level -> the state dict of the port's module of the same
    names (``models/vgg.py``, ``models/lpips.py``), float32."""
    p = tree["params"] if "params" in tree else tree
    out = {}

    def walk(node, prefix):
        for name, v in node.items():
            if name == "kernel":
                k = np.asarray(v, dtype=np.float32).transpose(3, 2, 0, 1)
                out[prefix + "weight"] = torch.from_numpy(
                    np.array(k, dtype=np.float32, order="C"))
            elif name == "bias":
                out[prefix + "bias"] = torch.from_numpy(
                    np.array(v, dtype=np.float32))
            else:
                walk(v, f"{prefix}{name}.")

    walk(p, "")
    return out


# Flax layer name -> the port's (the reference's) parameter prefix, per
# discriminator, and the classifier's (Flax name, prefix, channels,
# stride-2 convolutions before it).
_DISC_LAYOUTS = {
    "esr": ({"block0_conv0": "model.0", "block0_conv1": "model.2",
             "block1_conv0": "model.4", "block1_conv1": "model.6"},
            ("classifier", "classifier.0", 32, 2)),
    "ls": ({f"block{i}_conv": f"model.{2 * i}" for i in range(4)},
           ("adv", "adv_layer", 128, 4)),
    "basic": ({"conv": "model.0"}, ("adv", "adv_layer", 16, 1)),
}


def disc_state_dict(tree: Mapping[str, Any], patch_hw=None,
                    arch: str = "esr") -> Dict[str, torch.Tensor]:
    """A Flax discriminator tree (``models/discriminator.py``; numpy leaves,
    with or without the ``params`` level) -> the state dict of the port's
    module of ``arch`` ("esr", "ls", "basic" or "dc"), float32.

    The convolutions go HWIO -> OIHW. The classifier's ``[h * w * c, 1]``
    kernel flattens Flax's NHWC map: it is reshaped ``(h, w, c)``, put in
    the port's NCHW order ``(c, h, w)`` and flattened to ``[1, c * h * w]``,
    where ``(h, w)`` is the crop ``patch_hw`` halved, rounding up, once per
    stride-2 convolution. DC has no linear layer and takes no
    ``patch_hw``."""
    p = tree["params"] if "params" in tree else tree

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    def oihw(kernel):
        return t(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1))

    out = {}
    if arch == "dc":
        for name, layer in p.items():
            key = ("conv_out" if name == "conv_out"
                   else f"blocks.{int(name[len('block'):])}")
            out[f"{key}.weight"] = oihw(layer["kernel"])
        return out
    conv_map, (lin_name, lin_key, c, n_stride2) = _DISC_LAYOUTS[arch]
    for name, layer in p.items():
        if name in conv_map:
            out[f"{conv_map[name]}.weight"] = oihw(layer["kernel"])
            out[f"{conv_map[name]}.bias"] = t(layer["bias"])
        elif name == lin_name:
            if patch_hw is None:
                raise ValueError("patch_hw (nH, nW) is needed to reorder the "
                                 "classifier's flattened input")
            h, w = feature_hw(patch_hw, n_stride2)
            k = np.asarray(layer["kernel"], np.float32)
            if k.shape[0] != h * w * c:
                raise ValueError(
                    f"discriminator {lin_name} has {k.shape[0]} inputs, a "
                    f"{patch_hw[0]}x{patch_hw[1]} crop gives {h}x{w}x{c}")
            out[f"{lin_key}.weight"] = t(
                k[:, 0].reshape(h, w, c).transpose(2, 0, 1).reshape(1, -1))
            out[f"{lin_key}.bias"] = t(layer["bias"])
        else:
            raise KeyError(f"unexpected discriminator layer {name!r}")
    return out
