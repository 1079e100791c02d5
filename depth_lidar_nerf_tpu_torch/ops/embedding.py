"""Frequency positional encoding (port of ``ops/embedding.py``).

Identity plus ``sin``/``cos`` over octave bands ``2^0 .. 2^(multires-1)``,
laid out per frequency as ``[x, sin(f0 x), cos(f0 x), sin(f1 x), ...]`` with
each block covering all input dims — the row order of the Flax weights
(reference ``run_nerf_helpers.py:25-73``).
"""

from __future__ import annotations

import torch


def embedding_dim(input_dims: int, num_freqs: int, include_input: bool = True) -> int:
    """Output channel count: e.g. 3 dims, 10 freqs -> 63; 3 dims, 4 freqs -> 27."""
    out = input_dims if include_input else 0
    return out + input_dims * 2 * num_freqs


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """Encode ``x[..., d] -> [..., embedding_dim(d, num_freqs)]``.

    The octaves are exact powers of two, so every phase ``2^f x`` is exact in
    float32. ``num_freqs == 0`` is the identity (reference ``i_embed == -1``).
    """
    if num_freqs == 0:
        return x
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # [..., F, d]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, d]
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * d)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
