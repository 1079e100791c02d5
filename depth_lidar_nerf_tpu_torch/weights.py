"""Weights from the JAX package's Flax pytrees.

Flax ``Dense`` stores ``kernel [in, out]`` and ``bias [out]`` under the layer
name (``models/nerf_mlp.py:50-81``); ``nn.Linear`` stores ``weight [out, in]``.
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
