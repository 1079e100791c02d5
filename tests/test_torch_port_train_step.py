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

import pytest

from torch_port_train_helpers import three_steps_against_jax, train_pair


@pytest.mark.parametrize("cull_eps", [1e-4, 0.0])
def test_train_steps_match_jax(monkeypatch, cull_eps):
    jcalls, tcalls = three_steps_against_jax(monkeypatch,
                                             train_pair(monkeypatch, cull_eps))
    coarse = "_bwd_culled_dparams" if cull_eps > 0 else "_bwd_dense_dparams"
    # JAX traces its step once; the port runs both backwards every step.
    assert sorted(jcalls) == sorted([coarse, "_bwd_acts_dparams"])
    assert sorted(tcalls) == sorted(jcalls * 3)
