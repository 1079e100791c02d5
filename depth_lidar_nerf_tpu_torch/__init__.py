"""PyTorch + CUDA port of ``depth_lidar_nerf_tpu`` for one NVIDIA H100.

The module layout mirrors the JAX package, so each port module sits at the
same path as its counterpart (``ops/fused_mlp_t.py`` here replaces
``depth_lidar_nerf_tpu/ops/fused_mlp_t.py``). The port imports ``torch`` and
never ``jax`` nor anything of the JAX package.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel under
``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(:mod:`depth_lidar_nerf_tpu_torch.ops._build`). Each kernel's wrapper keeps a
plain PyTorch version beside it, which it runs only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`depth_lidar_nerf_tpu_torch.device.resolve_device`).
"""

from depth_lidar_nerf_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
