"""Weights from the JAX package's Flax pytrees.

Flax ``Dense`` stores ``kernel [in, out]`` and ``bias [out]`` under the layer
name (``models/nerf_mlp.py:50-81``); ``nn.Linear`` stores ``weight [out, in]``.
Flax ``Conv`` stores ``kernel [kh, kw, in, out]`` (HWIO); ``nn.Conv2d`` stores
``weight [out, in, kh, kw]`` (OIHW).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


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
