"""Kernel 2 (inverse-CDF sampling): the port's plain version against the
JAX Pallas kernel ``sample_pdf_pallas`` in the interpreter (``det=True``
gives both sides the same draws), and against the port's dense-compare
``sample_pdf`` on the same given draws."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

T = torch.from_numpy


def _inputs(N, B, seed):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(0, 1, (N, B)), -1).astype(np.float32)
    w = rng.exponential(1.0, (N, B - 1)).astype(np.float32)
    w[0] = 0.0  # the 1e-5 floor alone: a uniform pdf
    w[1, : B // 2] = 0.0  # a flat CDF stretch: the denominator guard
    return bins, w


@pytest.mark.parametrize("N,B,V", [(37, 63, 64), (300, 17, 40)])
def test_inverse_cdf_plain_matches_pallas_det(N, B, V):
    from depth_lidar_nerf_tpu.ops.sampling_pallas import sample_pdf_pallas
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import sample_pdf_cuda

    bins, w = _inputs(N, B, seed=N)
    ref = np.asarray(sample_pdf_pallas(jnp.asarray(bins), jnp.asarray(w), V,
                                       det=True, interpret=True))
    got = sample_pdf_cuda(T(bins), T(w), V, det=True).numpy()
    assert got.shape == (N, V)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_inverse_cdf_plain_matches_dense_compare_on_given_u():
    from depth_lidar_nerf_tpu_torch.ops.sampling import sample_pdf_from_u
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import (
        inverse_cdf, inverse_cdf_plain)

    bins, w = _inputs(64, 33, seed=9)
    g = torch.Generator().manual_seed(0)
    u = torch.rand((64, 48), generator=g)
    u[0, :3] = torch.tensor([0.0, 1.0, 0.5])
    launches = inverse_cdf.launches
    got = inverse_cdf(T(bins), T(w), u)
    assert inverse_cdf.launches == launches  # CPU tensors: plain version
    torch.testing.assert_close(got, inverse_cdf_plain(T(bins), T(w), u),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, sample_pdf_from_u(T(bins), T(w), u),
                               rtol=1e-5, atol=1e-6)
    assert (got >= T(bins)[:, :1]).all() and (got <= T(bins)[:, -1:]).all()


def test_sample_pdf_cuda_random_draws_follow_generator():
    from depth_lidar_nerf_tpu_torch.ops.sampling_cuda import sample_pdf_cuda

    bins, w = _inputs(16, 9, seed=3)
    a = sample_pdf_cuda(T(bins), T(w), 8,
                        generator=torch.Generator().manual_seed(1))
    b = sample_pdf_cuda(T(bins), T(w), 8,
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sample_pdf_cuda(T(bins), T(w), 8)
    with pytest.raises(ValueError):
        sample_pdf_cuda(T(bins), T(w[:, :-1]), 8, det=True)
