"""Training steps of the port against JAX ``make_train_step`` (Pallas kernels
in the interpreter), from the same weights on the same ray indices, on the
culled (``cull_eps=1e-4``) and the dense (``cull_eps=0``) coarse routes; the
fine pass takes the saved-activation route on both.

Three steps. Before each, the port takes JAX's parameters and Adam moments,
so every step is compared from one state (Adam's step count, bias
correction and LR schedule run on through counts 1-3). Without that, Adam
turns float32 summation noise into diverging trajectories: its first update
is lr * g / (|g| + 1e-8), whose sign for a gradient element that is noise
around zero is arbitrary.

Tolerances: the metrics at rtol 1e-4; the updated parameters at rtol 1e-4
with atol 2.5e-5, 1/20 of the step's rate of 5e-4: an element whose
gradient is a sum of ~4,000 terms that nearly cancel carries a float32
relative error of a few percent, which Adam's normalisation passes into the
update (measured: one element in 16,384 off by 5.9e-6); the Adam moments at rtol 1e-3 (float32; they carry the
gradients' summation-order differences undivided) with an atol of 1e-3 of
each tensor's largest moment."""

import jax
import numpy as np
import pytest
import torch

from torch_port_train_helpers import (jax_step_indices, spy_routes,
                                      train_pair)


def _jax_state_dicts(js):
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    adam = js.opt_state[0]
    return [params_from_jax(jax.tree.map(np.asarray, t))
            for t in (js.params, adam.mu, adam.nu)]


@pytest.mark.parametrize("cull_eps", [1e-4, 0.0])
def test_train_steps_match_jax(monkeypatch, cull_eps):
    import depth_lidar_nerf_tpu.ops.fused_mlp_t as jfmt
    from depth_lidar_nerf_tpu_torch.ops import fused_mlp_t as tfmt

    t = train_pair(monkeypatch, cull_eps)
    jcalls, tcalls = [], []
    spy_routes(monkeypatch, jfmt, jcalls)
    spy_routes(monkeypatch, tfmt, tcalls)
    js, ts = t["jax_state"], t["port_state"]
    j_rgb, j_dep = t["jax_tables"]
    nets = {"coarse": ts.models.coarse, "fine": ts.models.fine}
    opt = ts.optimizer
    for i in range(3):
        if i:  # start the port's step from JAX's state
            params, mu, nu = _jax_state_dicts(js)
            with torch.no_grad():
                for net, m in nets.items():
                    for name, p in m.named_parameters():
                        p.copy_(params[net][name])
                        opt.state[p]["exp_avg"].copy_(mu[net][name])
                        opt.state[p]["exp_avg_sq"].copy_(nu[net][name])
        rng = jax.random.key(100 + i)
        idx, idx_d = jax_step_indices(rng, t["n_rgb"], t["n_depth"],
                                      j_rgb.origins.shape[0],
                                      j_dep.origins.shape[0])
        js, jm = t["jax_step"](js, j_rgb, j_dep, None, None, rng)
        tm = t["port_step"](ts, *t["port_tables"], idx=idx, idx_d=idx_d)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        params, mu, nu = _jax_state_dicts(js)
        for net, m in nets.items():
            for name, p in m.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), params[net][name].numpy(), rtol=1e-4,
                    atol=2.5e-5, err_msg=f"step {i} {net} {name}")
                for key, want in (("exp_avg", mu), ("exp_avg_sq", nu)):
                    w = want[net][name].numpy()
                    np.testing.assert_allclose(
                        opt.state[p][key].numpy(), w, rtol=1e-3,
                        atol=1e-3 * np.abs(w).max() + 1e-30,
                        err_msg=f"step {i} {net} {name} {key}")
    assert ts.step == int(js.step) == 3
    coarse = "_bwd_culled_dparams" if cull_eps > 0 else "_bwd_dense_dparams"
    # JAX traces its step once; the port runs both backwards every step.
    assert sorted(jcalls) == sorted([coarse, "_bwd_acts_dparams"])
    assert sorted(tcalls) == sorted(jcalls * 3)
