"""The port's training driver (``train/loop.py:train``, checkpoints, the
reference ``.tar`` import, the CLI) on the CPU, against the JAX driver where
both can run: the flag checks, ``--render_only`` frames from one exported
``.tar``, the imported weights and Adam moments; and JAX's end-to-end driver
tests (``tests/test_train_e2e.py``) at their sizes."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    d = tmp_path_factory.mktemp("scene")
    make_scene(str(d), n_images=3, H=24, W=32, focal=30.0, n_depth_points=120)
    return str(d)


def _fields(scene_dir, tmp_path, **kw):
    base = dict(
        expname="t", basedir=str(tmp_path), datadir=scene_dir,
        dataset_type="llff", factor=0, llffhold=0, test_scene=[2],
        N_rand=96, N_samples=12, N_importance=8, netdepth=2, netwidth=48,
        netdepth_fine=2, netwidth_fine=48, use_viewdirs=True, no_ndc=True,
        N_iters=60, i_print=30, i_weights=60, i_testset=0, i_video=0,
        lrate=5e-3, multires=6, multires_views=2, should_seed=True,
        steps_per_dispatch=1,
    )
    base.update(kw)
    return base


def _cfg(scene_dir, tmp_path, **kw):
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig

    return TrainConfig(**_fields(scene_dir, tmp_path, **kw))


def _train(cfg, **kw):
    from depth_lidar_nerf_tpu_torch.train.loop import train

    return train(cfg, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """The summary writer writes ``runs/<expname>`` under the working
    directory, as JAX's does. One intra-op thread: the loops here run
    thousands of tiny ops, which spin-wait for minutes on a thread pool
    whose cores other test workers hold."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(state):
    return {f"{net}.{k}": v.detach().clone()
            for net, m in (("coarse", state.models.coarse),
                           ("fine", state.models.fine))
            for k, v in m.state_dict().items()}


def _moments(state):
    names = {id(p): f"{net}.{k}" for net, m in (("coarse", state.models.coarse),
                                                ("fine", state.models.fine))
             for k, p in m.named_parameters()}
    return {names[id(p)]: {k: v.clone() for k, v in st.items()}
            for p, st in state.optimizer.state.items()}


def _assert_same_state(a, b):
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    pa, pb = _params(a), _params(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    ma, mb = _moments(a), _moments(b)
    assert ma.keys() == mb.keys() and len(ma) == len(pa)
    for k in ma:
        for which in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ma[k][which], mb[k][which]), (k, which)


# ------------------------------------------------------------- flag checks

_REJECTIONS = {
    "depth_with_rgb": (dict(depth_with_rgb=True), "depth_with_rgb is unsupported"),
    "feature_loss_type": (dict(feature_loss=True, feature_loss_type="x"),
                          "FEATURE LOSS TYPE"),
    "lpips_backbone": (dict(feature_loss=True, feature_loss_type="lpips",
                            lpips_backbone="resnet", nH=32, nW=32),
                       "is not implemented"),
    "lpips_patch": (dict(feature_loss=True, feature_loss_type="lpips", nH=16,
                         nW=32), "needs patches >= 31 px"),
    "render_grid_no_fine": (dict(render_grid=16, N_importance=0),
                            "no fine pass"),
    "render_grid_refinement": (dict(render_grid_fine_only=True),
                               "need --render_grid R"),
    "render_fine_only_no_fine": (dict(render_fine_only=True, N_importance=0),
                                 "--render_fine_only renders"),
    "grid_train_no_fine": (dict(grid_train=True, N_importance=0),
                           "no fine pass to train"),
    "grid_train_frozen_alpha": (dict(grid_train=True, no_coarse=True),
                                "incompatible with the frozen-alpha"),
    "grid_train_res": (dict(grid_train=True, grid_train_res=1),
                       "grid_train_res > 1"),
    "grid_refinement": (dict(grid_train_samples=32), "need it to be set"),
}


@pytest.mark.parametrize("case", list(_REJECTIONS))
def test_validate_flags_rejects_as_jax(scene_dir, tmp_path, case):
    """Each rejection of JAX ``_validate_flags`` (``loop.py:256-322``): the
    same exception type, the same message, raised by ``train`` before the
    experiment directory exists."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.loop import _validate_flags as jvalidate
    from depth_lidar_nerf_tpu_torch.train.loop import _validate_flags

    kw, phrase = _REJECTIONS[case]
    fields = _fields(scene_dir, tmp_path, **kw)
    with pytest.raises(Exception) as ref:
        jvalidate(JCfg(**fields))
    cfg = _cfg(scene_dir, tmp_path, **kw)
    with pytest.raises(type(ref.value), match=re.escape(phrase)) as got:
        _validate_flags(cfg)
    assert type(got.value) is type(ref.value)
    assert str(got.value) == str(ref.value)
    with pytest.raises(type(ref.value)):
        _train(cfg)
    assert not os.path.exists(os.path.join(str(tmp_path), "t"))


_UNPORTED = {
    "no_batching": dict(no_batching=True),
    "feature_loss": dict(feature_loss=True),
    "gan_loss": dict(gan_loss=True),
    "depth_inverse_loss": dict(depth_inverse_loss=True),
    "patch_ng_int8": dict(patch_ng_int8=True),
    "grid_train_feature_loss": dict(grid_train=True, feature_loss=True),
    "alpha_model_path": dict(alpha_model_path="alpha.tar"),
    "no_coarse": dict(no_coarse=True),
    "mesh_shape": dict(mesh_shape=[2]),
    "dist_coordinator": dict(dist_coordinator="localhost:1234"),
    "mesh_shape_tp": dict(mesh_shape=[2, 2]),
    "mesh_shape_tp_plain": dict(mesh_shape=[2, 2], use_fused_mlp=False),
}


@pytest.mark.parametrize("case", list(_UNPORTED))
def test_unported_flags_refused_before_writing(scene_dir, tmp_path, case):
    """Every flag the port once refused now passes the training entry
    point's checks (``_validate_flags`` and the route check of ``train``): the patch
    losses, the GAN, single-image batching, the frozen-alpha model, data
    and tensor parallelism train (their own test files train them). The
    one refusal left is JAX's: ``mesh_shape [2, 2]`` on the fused kernels
    raises JAX's ``ValueError`` before anything is written."""
    from depth_lidar_nerf_tpu.train import state as jstate
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.config import render_config_from
    from depth_lidar_nerf_tpu_torch.train.loop import _validate_flags
    from depth_lidar_nerf_tpu_torch.train.state import check_tp_route

    cfg = _cfg(scene_dir, tmp_path, **_UNPORTED[case])
    _validate_flags(cfg)
    if case != "mesh_shape_tp":
        check_tp_route(cfg)
        return
    jcfg = JCfg(**_fields(scene_dir, tmp_path, **_UNPORTED[case]))
    with pytest.raises(ValueError) as want:
        jstate.build_models(jcfg, render_config_from(jcfg, 0, 2.0, 6.0))
    with pytest.raises(ValueError, match="model-TP mesh") as got:
        _train(cfg)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    assert not os.path.exists(os.path.join(str(tmp_path), "t"))


def test_mesh_of_one_device_and_dispatch_flags_are_accepted(scene_dir,
                                                            tmp_path, capsys):
    state = _train(_cfg(scene_dir, tmp_path, mesh_shape=[1], N_iters=2,
                        i_weights=0, steps_per_dispatch=0, N_rand=64))
    assert state.step == 2
    out = capsys.readouterr().out
    assert out.count("the port runs one step an iteration") == 1


def _profiled(path):
    """The top-level spans of a ``profile_dir`` run, from the recorder and
    from the chrome trace it wrote: ``[(name, id)]`` and the trace's
    ``record_function`` names, counted."""
    import collections
    import json

    from depth_lidar_nerf_tpu_torch.utils import tracing

    top = [(r.name, r.id) for r in tracing.records() if r.parent is None]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    return top, names


def test_profile_dir_and_debug_nans(scene_dir, tmp_path):
    """``profile_dir`` writes a torch.profiler trace of one print interval
    (here step 2 of 3, after step 1's warm-up) holding the program's spans;
    ``debug_nans`` turns autograd's anomaly detection on for the run
    only."""
    before = torch.is_anomaly_enabled()
    seen = []
    state = _train(_cfg(scene_dir, tmp_path, N_iters=3, i_print=1, i_weights=0,
                        N_rand=32, profile_dir=str(tmp_path / "prof"),
                        debug_nans=True),
                   metrics_hook=lambda i, m: seen.append(
                       torch.is_anomaly_enabled()))
    assert state.step == 3 and seen == [True, True, True]
    assert torch.is_anomaly_enabled() == before
    top, names = _profiled(tmp_path / "prof" / "trace.json")
    assert top == [("step", 2), ("loop.fetch", 2)]
    assert names["step"] == 1 and names["loop.fetch"] == 1
    for phase in ("step.draw", "step.render", "step.loss", "step.backward",
                  "step.optimizer"):
        assert names[phase] == 1, phase


# --------------------------------------------------- the reference .tar


def _jax_state(jcfg, num_sem=0, step=0, sigma_bias=2.0):
    """A JAX ``TrainState`` of ``jcfg``'s models, the density bias raised
    so that the field is not transparent."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.train.config import render_config_from
    from depth_lidar_nerf_tpu.train.state import build_models, init_train_state

    rcfg = render_config_from(jcfg, num_sem, 0.0, 1.0)
    models = build_models(jcfg, rcfg)
    state = init_train_state(jcfg, rcfg, models, jax.random.key(3))
    params = jax.tree.map(np.asarray, state.params)
    for k in ("coarse", "fine"):
        sig = params[k]["params"]["sigma"]
        sig["bias"] = sig["bias"] + sigma_bias
    return state.replace(params=params, step=jnp.int32(step))


def test_reference_tar_imports_bit_exact(scene_dir, tmp_path, capsys):
    """JAX ``export_reference_checkpoint`` -> the port's import equals
    ``params_from_jax`` of the same params bit for bit (with a semantic
    head), and the step comes from ``global_step``."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.torch_import import \
        export_reference_checkpoint
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import render_config_from
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.torch_import import \
        import_reference_checkpoint
    from depth_lidar_nerf_tpu_torch.weights import params_from_jax

    fields = _fields(scene_dir, tmp_path, netdepth=3, netwidth=32)
    js = _jax_state(JCfg(**fields), num_sem=4, step=17)
    tar = export_reference_checkpoint(js, str(tmp_path / "ref.tar"),
                                      verbose=False)
    cfg = _cfg(scene_dir, tmp_path, netdepth=3, netwidth=32)
    rcfg = render_config_from(cfg, 4, 0.0, 1.0)
    state = init_train_state(cfg, build_models(cfg, rcfg, device="cpu"))
    import_reference_checkpoint(checkpoint.load_file(tar), state, source=tar)
    assert state.step == 17 and state.optimizer.count == 0
    assert "imported reference checkpoint" in capsys.readouterr().out
    want = params_from_jax(js.params)
    for net in ("coarse", "fine"):
        got = getattr(state.models, net).state_dict()
        assert got.keys() == want[net].keys()
        assert any(k.startswith("semantic_1") for k in got)
        for k in got:
            assert torch.equal(got[k], want[net][k]), (net, k)
    # Another topology is refused with JAX's message.
    narrow = _cfg(scene_dir, tmp_path, netdepth=3, netwidth=16)
    small = init_train_state(narrow, build_models(
        narrow, render_config_from(narrow, 4, 0.0, 1.0), device="cpu"))
    with pytest.raises(ValueError, match="check netdepth/netwidth/multires"):
        import_reference_checkpoint(checkpoint.load_file(tar), small)


def _reference_optimizer(coarse_sd, fine_sd, seed=0, drop=None):
    """A hand-built reference ``optimizer_state_dict``: one Adam over the
    coarse then the fine ``NeRF.parameters()`` (``run_nerf.py:434-441``)."""
    from depth_lidar_nerf_tpu.train.torch_import import _torch_param_names

    gen = torch.Generator().manual_seed(seed)
    shapes = [coarse_sd[n].shape for n in _torch_param_names(coarse_sd)]
    shapes += [fine_sd[n].shape for n in _torch_param_names(fine_sd)]
    state = {i: {"step": torch.tensor(9.0),
                 "exp_avg": torch.randn(s, generator=gen) * 1e-3,
                 "exp_avg_sq": torch.rand(s, generator=gen) * 1e-6}
             for i, s in enumerate(shapes) if i != drop}
    return {"state": state, "param_groups": [{
        "lr": 5e-4, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
        "amsgrad": False, "params": list(range(len(shapes)))}]}


def test_reference_adam_moments_match_jax(scene_dir, tmp_path, capsys):
    """On a hand-built reference optimizer state the port's moments equal
    JAX ``import_adam_state``'s ([out, in] against Flax's [in, out]), and the
    count is the global step; a state that does not fit leaves both fresh,
    with JAX's printed reason."""
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.state import make_optimizer as jopt
    from depth_lidar_nerf_tpu.train.torch_import import (
        _nerf_to_torch_state_dict, import_reference_checkpoint as jimport)
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import render_config_from
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)
    from depth_lidar_nerf_tpu_torch.train.torch_import import \
        import_reference_checkpoint

    jcfg = JCfg(**_fields(scene_dir, tmp_path))
    js = _jax_state(jcfg)
    sds = {k: {n: torch.from_numpy(v) for n, v in
               _nerf_to_torch_state_dict(js.params[k]).items()}
           for k in ("coarse", "fine")}
    cfg = _cfg(scene_dir, tmp_path)
    for drop in (None, 5):
        tar = str(tmp_path / f"ref{drop}.tar")
        torch.save({"global_step": 9, "network_fn_state_dict": sds["coarse"],
                    "network_fine_state_dict": sds["fine"],
                    "optimizer_state_dict": _reference_optimizer(
                        sds["coarse"], sds["fine"], drop=drop)}, tar)
        jstate = jimport(tar, js, optimizer=jopt(jcfg), verbose=True)
        ref_out = capsys.readouterr().out
        state = init_train_state(cfg, build_models(
            cfg, render_config_from(cfg, 0, 0.0, 1.0), device="cpu"))
        import_reference_checkpoint(checkpoint.load_file(tar), state,
                                    source=tar)
        out = capsys.readouterr().out
        assert state.step == int(jstate.step) == 9
        if drop is not None:
            assert "optimizer moments not imported" in ref_out
            assert "optimizer moments not imported" in out
            assert "keeping fresh init (--no_reload_optimizer semantics)" in out
            assert state.optimizer.count == 0 and not state.optimizer.state
            assert out.splitlines()[-1].endswith("(step 9; params)")
            continue
        assert ref_out.splitlines()[-1].endswith("(step 9; opt_state, params)")
        assert out.splitlines()[-1].endswith("(step 9; opt_state, params)")
        adam = next(s for s in jstate.opt_state if hasattr(s, "mu"))
        assert state.optimizer.count == int(adam.count) == 9
        for net in ("coarse", "fine"):
            module = getattr(state.models, net)
            for name, p in module.named_parameters():
                layer, kind = name.rsplit(".", 1)
                key = "kernel" if kind == "weight" else "bias"
                for ours, theirs in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                    ref = np.asarray(theirs[net]["params"][layer][key])
                    got = state.optimizer.state[p][ours].numpy()
                    np.testing.assert_array_equal(
                        got.T if kind == "weight" else got, ref,
                        err_msg=f"{net}.{name} {ours}")


def test_render_only_matches_jax(tmp_path):
    """JAX's and the port's drivers serve ``--render_only --render_test``
    from one exported ``.tar`` on one JAX-written scene (NDC, coarse + fine):
    ``000.npz`` equal at the serving tests' float32 limits."""
    from depth_lidar_nerf_tpu.data.synthetic import make_scene as jmake
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.loop import train as jtrain
    from depth_lidar_nerf_tpu.train.torch_import import \
        export_reference_checkpoint

    scene = str(tmp_path / "scene")
    jmake(scene, n_images=3, H=20, W=28, focal=24.0, n_depth_points=30,
          backdrop=True)
    kw = dict(no_ndc=False, N_samples=16, N_importance=16, render_only=True,
              render_test=True)
    js = _jax_state(JCfg(**_fields(scene, tmp_path, **kw)), step=7)
    tar = export_reference_checkpoint(js, str(tmp_path / "ref.tar"),
                                      verbose=False)
    jtrain(JCfg(**_fields(scene, tmp_path / "jax", ft_path=tar, **kw)))
    _train(_cfg(scene, tmp_path / "port", ft_path=tar, **kw))
    sub = os.path.join("t", "renderonly_test_000007")
    ref = np.load(tmp_path / "jax" / sub / "000.npz")
    got = np.load(tmp_path / "port" / sub / "000.npz")
    assert sorted(got.files) == sorted(ref.files) == ["acc", "depth", "disp",
                                                      "rgb"]
    acc = ref["acc"]
    assert acc.max() > 0.1  # the field is not transparent
    for k in ("rgb", "acc", "depth", "disp"):
        a, b = ref[k], got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "disp":
            a, b = a[acc > 1e-3], b[acc > 1e-3]
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)
    files = sorted(os.listdir(tmp_path / "port" / sub))
    assert {"000.png", "000.npz", "000_depth.png"} <= set(files)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_round_trip_is_bit_exact(scene_dir, tmp_path):
    from depth_lidar_nerf_tpu_torch.train import checkpoint
    from depth_lidar_nerf_tpu_torch.train.config import render_config_from
    from depth_lidar_nerf_tpu_torch.train.state import (build_models,
                                                        init_train_state)

    cfg = _cfg(scene_dir, tmp_path, N_iters=6, i_weights=3, i_print=0)
    state = _train(cfg)
    assert state.optimizer.count == 6
    d = checkpoint.ckpt_dir(cfg.basedir, cfg.expname)
    assert checkpoint.steps(d) == [3, 6]
    rcfg = render_config_from(cfg, 0, 0.0, 1.0)
    fresh = init_train_state(cfg, build_models(cfg, rcfg, device="cpu",
                                               seed=99))
    topo = checkpoint.topology(cfg, 0)
    checkpoint.restore(checkpoint.load_file(checkpoint.path_of(d, 6)), fresh,
                       topo)
    _assert_same_state(fresh, state)
    other = checkpoint.topology(cfg.replace(netwidth=64), 0)
    with pytest.raises(ValueError, match=r"netwidth=48 \(this run: 64\)"):
        checkpoint.restore(checkpoint.load_file(checkpoint.path_of(d, 6)),
                           fresh, other)


def test_checkpoints_keep_newest_five_latest_is_highest(scene_dir, tmp_path):
    from depth_lidar_nerf_tpu_torch.train import checkpoint

    cfg = _cfg(scene_dir, tmp_path, N_iters=8, i_weights=1, i_print=0,
               N_rand=32)
    _train(cfg)
    d = checkpoint.ckpt_dir(cfg.basedir, cfg.expname)
    assert checkpoint.steps(d) == [4, 5, 6, 7, 8]
    assert sorted(os.listdir(d)) == sorted(f"{s}.pt" for s in (4, 5, 6, 7, 8))
    # "Latest" is the highest step, whatever the files' times.
    os.utime(checkpoint.path_of(d, 8), (1, 1))
    assert checkpoint.latest_step(d) == 8
    os.rename(checkpoint.path_of(d, 4), checkpoint.path_of(d, 40))
    assert checkpoint.latest_step(d) == 40


def test_no_reload_and_no_reload_optimizer(scene_dir, tmp_path, capsys):
    """``--no_reload`` starts afresh beside a checkpoint; with
    ``--no_reload_optimizer`` a resumed run keeps the checkpoint's weights
    and step and a fresh optimizer (JAX ``loop.py:620-652``)."""
    cfg = _cfg(scene_dir, tmp_path, N_iters=10, i_weights=10, i_print=0)
    trained = _train(cfg)
    capsys.readouterr()
    fresh = _train(cfg.replace(no_reload=True, N_iters=0))
    out = capsys.readouterr().out
    assert "resumed" not in out and fresh.step == 0
    assert not torch.equal(fresh.models.coarse.trunk_0.weight,
                           trained.models.coarse.trunk_0.weight)
    reset = _train(cfg.replace(no_reload_optimizer=True))
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 10" in out
    assert "--no_reload_optimizer: optimizer state reset" in out
    assert reset.step == 10 and reset.optimizer.count == 0
    assert not reset.optimizer.state
    for k, v in _params(trained).items():
        assert torch.equal(_params(reset)[k], v), k
    # One more step from the reset optimizer: the learning rate of count 0.
    more = _train(cfg.replace(no_reload_optimizer=True, N_iters=11))
    assert more.step == 11 and more.optimizer.count == 1


def test_resume_equals_uninterrupted_run(scene_dir, tmp_path, capsys):
    """30 steps, then a resume to 45, equal an uninterrupted 45-step run
    bit for bit: weights, Adam moments, count and step (JAX
    ``test_checkpoint_resume``, ``tests/test_train_e2e.py:113``)."""
    from depth_lidar_nerf_tpu_torch.train import checkpoint

    kw = dict(colmap_depth=True, depth_loss=True, depth_lambda=0.05,
              raw_noise_std=1.0, i_print=15)
    cfg = _cfg(scene_dir, tmp_path / "a", N_iters=30, i_weights=30, **kw)
    _train(cfg)
    resumed = _train(cfg.replace(N_iters=45))
    assert "resumed from checkpoint at step 30" in capsys.readouterr().out
    whole = _train(_cfg(scene_dir, tmp_path / "b", N_iters=45, i_weights=45,
                        **kw))
    assert resumed.step == whole.step == 45
    _assert_same_state(resumed, whole)
    d = checkpoint.ckpt_dir(cfg.basedir, cfg.expname)
    assert checkpoint.steps(d) == [30, 45]


def test_ft_path_directory_and_foreign_file_refused(scene_dir, tmp_path):
    cfg = _cfg(scene_dir, tmp_path, ft_path=str(tmp_path))
    with pytest.raises(ValueError, match="export_reference_checkpoint"):
        _train(cfg)
    bad = str(tmp_path / "other.pt")
    torch.save({"weights": torch.zeros(2)}, bad)
    with pytest.raises(ValueError, match="neither a checkpoint"):
        _train(cfg.replace(ft_path=bad))


def test_ft_path_own_checkpoint(scene_dir, tmp_path, capsys):
    from depth_lidar_nerf_tpu_torch.train import checkpoint

    cfg = _cfg(scene_dir, tmp_path / "a", N_iters=5, i_weights=5, i_print=0)
    first = _train(cfg)
    path = checkpoint.path_of(checkpoint.ckpt_dir(cfg.basedir, cfg.expname), 5)
    pinned = _train(_cfg(scene_dir, tmp_path / "b", N_iters=5, ft_path=path))
    assert f"loaded --ft_path checkpoint {path} (step 5)" in \
        capsys.readouterr().out
    _assert_same_state(pinned, first)


# ------------------------------------------------------------- the loop


def test_train_rgb_only_psnr_climbs(scene_dir, tmp_path, capsys):
    """JAX ``test_train_rgb_only_psnr_climbs`` (``tests/test_train_e2e.py:57``):
    the last ``[TRAIN]`` PSNR at least 2 dB above the first and above 18;
    every ``[TRAIN]`` line in JAX's format, the same values to the hook; the
    ``profile_dir`` trace of steps 21-40 holds the metric fetch and the
    checkpoint save."""
    seen = []
    cfg = _cfg(scene_dir, tmp_path, N_iters=200, i_print=20, i_weights=40,
               profile_dir=str(tmp_path / "prof"))
    state = _train(cfg, metrics_hook=lambda i, m: seen.append((i, m)))
    outp = capsys.readouterr().out
    lines = [l for l in outp.splitlines() if l.startswith("[TRAIN]")]
    assert len(lines) == 10 and [i for i, _ in seen] == list(range(20, 201, 20))
    for line, (i, m) in zip(lines, seen):
        assert re.fullmatch(r"\[TRAIN\] iter \d+ loss \d+\.\d{5} psnr "
                            r"-?\d+\.\d{2} rays/s [\d,]+", line), line
        assert line.startswith(f"[TRAIN] iter {i} loss {m['loss']:.5f} "
                               f"psnr {m['psnr']:.2f} rays/s ")
    first = float(lines[0].split("psnr")[1].split()[0])
    last = float(lines[-1].split("psnr")[1].split()[0])
    assert last > first + 2.0, outp
    assert last > 18.0, outp
    assert state.step == 200
    # The profiled interval, steps 21-40, holds the fetch and the save.
    top, names = _profiled(tmp_path / "prof" / "trace.json")
    assert [i for n, i in top if n == "step"] == list(range(21, 41))
    assert ("loop.fetch", 40) in top and ("loop.save", 40) in top
    assert names["loop.fetch"] == 1 and names["loop.save"] == 1


def test_train_with_depth_and_semantic(tmp_path):
    """JAX ``test_train_with_depth_and_semantic`` (``:103``), with a
    held-out evaluation at the end."""
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene

    scene = str(tmp_path / "scene")
    make_scene(scene, n_images=3, H=24, W=32, focal=30.0, n_depth_points=120)
    cfg = _cfg(scene, tmp_path, colmap_depth=True, depth_loss=True,
               depth_lambda=0.05, semantic_loss=True, semantic_lambda=0.01,
               N_iters=40, i_weights=40, i_testset=40)
    seen = []
    state = _train(cfg, metrics_hook=lambda i, m: seen.append(m))
    assert state.step == 40
    assert {"semantic_loss", "semantic_loss0", "depth_loss"} <= set(seen[-1])
    testdir = tmp_path / "t" / "testset_000040"
    assert sorted(os.listdir(testdir)) == ["000.npz", "000.png",
                                           "000_depth.png"]


def test_train_with_sigma_loss(scene_dir, tmp_path):
    seen = []
    state = _train(_cfg(scene_dir, tmp_path, colmap_depth=True, depth_loss=True,
                        sigma_loss=True, N_iters=20, i_print=10, i_weights=20),
                   metrics_hook=lambda i, m: seen.append(m))
    assert state.step == 20
    assert all(np.isfinite(m["sigma_loss"]) for m in seen)


def test_checkpoint_resume(scene_dir, tmp_path):
    """JAX ``test_checkpoint_resume`` (``:113``)."""
    cfg = _cfg(scene_dir, tmp_path, N_iters=30, i_weights=30)
    _train(cfg)
    state = _train(cfg.replace(N_iters=45))
    assert state.step == 45
    ckpts = os.listdir(os.path.join(str(tmp_path), "t", "checkpoints"))
    assert any("45" in c for c in ckpts)


def test_render_only(scene_dir, tmp_path):
    """JAX ``test_render_only`` (``:123``), and the other render-only
    outputs: the training views, the spiral path and the depth rays."""
    cfg = _cfg(scene_dir, tmp_path, N_iters=10, i_weights=10, colmap_depth=True)
    _train(cfg)
    _train(cfg.replace(render_only=True, render_test=True))
    outdir = os.path.join(str(tmp_path), "t", "renderonly_test_000010")
    files = os.listdir(outdir)
    assert "000.png" in files and "000.npz" in files
    assert "000_depth.png" in files
    _train(cfg.replace(render_only=True, render_train=True, render_factor=2))
    rgb = np.load(os.path.join(str(tmp_path), "t", "renderonly_train_000010",
                               "001.npz"))["rgb"]
    assert rgb.shape == (12, 16, 3)
    _train(cfg.replace(render_only=True, render_test_ray=True))
    rays = os.listdir(os.path.join(str(tmp_path), "t", "renderonly_rays_000010"))
    assert sorted(rays) == ["cameras.ply", "depth_rays.ply"]


def test_cli_needs_a_card_and_refuses_multi_host(scene_dir, tmp_path):
    cfgfile = tmp_path / "x.txt"
    cfgfile.write_text(f"datadir = {scene_dir}\nbasedir = {tmp_path}\n"
                       "factor = 0\nN_iters = 2\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "depth_lidar_nerf_tpu_torch.train",
            "--config", str(cfgfile)]
    out = subprocess.run(base, capture_output=True, text=True, env=env,
                         timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    # Multi-host training is ported; without a card its process refuses to
    # join the group, before it writes anything.
    out = subprocess.run(base + ["--dist_coordinator", "h:1",
                                 "--dist_num_processes", "2",
                                 "--dist_process_id", "0"],
                         capture_output=True, text=True, env=env, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not os.path.exists(tmp_path / "exp")
