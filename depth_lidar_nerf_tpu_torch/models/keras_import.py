"""Import original-NeRF Keras weight lists into a :class:`~models.nerf_mlp.
NeRFMLP` (port of ``models/keras_import.py``).

Parity: ``NeRF.load_weights_from_keras`` (``run_nerf_helpers.py:147-174``) —
the original TF NeRF released weights as a flat numpy list
[W0, b0, W1, b1, ..., feature_W, feature_b, views_W, views_b, rgb_W, rgb_b,
alpha_W, alpha_b]. Keras stores each kernel ``[in, out]``; ``nn.Linear``
stores ``[out, in]``, so each kernel is transposed, as the torch reference
does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def keras_state_dict(weights: Sequence, depth: int) -> Dict[str, torch.Tensor]:
    """The Keras list -> the entries of a ``NeRFMLP`` state dict it holds
    (the trunk, ``feature``, ``views_0``, ``rgb``, ``sigma``), float32."""
    weights = [np.asarray(w, np.float32) for w in weights]
    names = [f"trunk_{i}" for i in range(depth)] + [
        "feature", "views_0", "rgb", "sigma"]
    out = {}
    for k, name in enumerate(names):
        w, b = weights[2 * k], weights[2 * k + 1]
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        out[f"{name}.bias"] = torch.from_numpy(b.reshape(-1).copy())
    return out


def load_weights_from_keras(module: torch.nn.Module, weights: Sequence,
                            depth: int) -> torch.nn.Module:
    """Load the Keras list into ``module`` (JAX ``load_weights_from_keras``):
    its layers take the list's weights, any other (a semantic head) keeps
    its own. Returns ``module``."""
    sd = dict(module.state_dict())
    sd.update(keras_state_dict(weights, depth))
    module.load_state_dict(sd)
    return module
