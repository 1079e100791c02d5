"""The semantic training step of the port against JAX ``make_train_step``
with ``semantic_loss=True`` (Pallas kernels in the interpreter): coarse D=4
and fine D=8 skip@4, both with a 19-class head, from the same weights on the
same ray indices, three steps, each from JAX's state (parameters and Adam
moments), as ``tests/test_torch_port_train_step.py`` compares the base step
and with its tolerances: metrics (``semantic_loss`` and ``semantic_loss0``
among them) at rtol 1e-4, parameters at rtol 1e-4 / atol 2.5e-5, Adam
moments at rtol 1e-3. Both passes take the semantic saved-activation route
(kernels 7 and 8) in both packages: the semantic composite has no culled
backward.

One exemption: a parameter element whose gradient is under twice its gap
between the packages is left out of the parameter comparison (at most 0.1%
of the elements of a step; measured: 83 of the 740,490 element checks of the
three steps; their gradients are still compared, through the Adam moments).
The semantic cotangent reaches every sample of a ray with the same weight
(the reference's unweighted sum), so a fine-trunk ReLU gate whose
pre-activation lies within float32 rounding of zero, open in one framework
and shut in the other, now moves gradient rows: measured, the fine trunk
below its last layer differs by up to 2.9e-3 of a gradient's mean between
the two packages, while each package's kernel path equals its own plain
module to 1e-4 of it (JAX's Flax module, the port's ``NeRFMLP``). Adam
turns an element whose gradient is below that noise into an update of
arbitrary sign (lr * g / |g|)."""

from torch_port_train_helpers import three_steps_against_jax, train_pair


def test_semantic_train_steps_match_jax(monkeypatch):
    t = train_pair(monkeypatch, 1e-4, semantic=True)
    jcalls, tcalls = three_steps_against_jax(monkeypatch, t,
                                             exempt_noise=True)
    assert jcalls == ["_bwd_acts_sem_dparams"] * 2
    assert tcalls == ["_bwd_acts_sem_dparams"] * 6
