"""The port's host-side tools against the JAX package's on the CPU: the
COLMAP model, dense-array and fused-point I/O, ``load_colmap_depth``, the
COLMAP pose pipeline, ``RayDataset``, the Keras weight import, the ResNet-18
features, the visualisation helpers and the HTML report. Numpy code copied
into the port is held bit for bit (files, arrays); the two networks (Keras
import, ResNet-18) at rtol 1e-5 of their outputs."""

import os
import struct

import numpy as np
import pytest
import torch

from depth_lidar_nerf_tpu.data import colmap_model as jcm
from depth_lidar_nerf_tpu_torch.data import colmap_model as tcm


def _random_model(cm, seed=0):
    """A COLMAP model of ``cm``'s classes (either package) from a seed:
    two cameras, images with and without points, points with tracks."""
    rng = np.random.default_rng(seed)
    cams = {1: cm.Camera(1, 1, 640, 480,
                         np.array([520.0, 521.5, 320.0, 240.25])),
            3: cm.Camera(3, 0, 100, 80, np.array([90.0, 50.0, 40.0]))}
    images = {}
    for iid in (2, 5, 6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        npts = 0 if iid == 5 else int(rng.integers(1, 6))
        images[iid] = cm.Image(
            iid, q, rng.normal(size=3), 1, f"im_{iid:03d}.png",
            rng.uniform(0, 600, (npts, 2)),
            rng.integers(-1, 50, npts).astype(np.int64))
    points = {}
    for pid in (7, 11, 13):
        tlen = int(rng.integers(1, 4))
        points[pid] = cm.Point3D(
            pid, rng.normal(size=3), rng.integers(0, 256, 3),
            float(rng.uniform(0, 2)),
            rng.integers(1, 6, tlen).astype(np.int32),
            rng.integers(0, 9, tlen).astype(np.int32))
    return cams, images, points


def _fields(model):
    """A model's contents as nested plain values (arrays as bytes)."""
    def one(x):
        return {k: (v.dtype.str, v.shape, v.tobytes())
                if isinstance(v, np.ndarray) else v
                for k, v in vars(x).items()}

    return [{k: one(v) for k, v in sorted(part.items())} for part in model]


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_io_matches_jax(tmp_path, ext):
    """The port writes the files JAX writes, byte for byte, and reads back
    what JAX reads, in both encodings."""
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jcm.write_model(*_random_model(jcm), dj, ext=ext)
    tcm.write_model(*_random_model(tcm), dt, ext=ext)
    assert _files(dj) == _files(dt)
    assert _fields(tcm.read_model(dj, ext)) == _fields(jcm.read_model(dj, ext))
    assert _fields(tcm.read_model(dt, ext)) == _fields(_random_model(tcm))


def test_qvec_rotmat_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        r = tcm.qvec2rotmat(q)
        assert np.array_equal(r, jcm.qvec2rotmat(q))
        assert np.array_equal(tcm.rotmat2qvec(r), jcm.rotmat2qvec(r))


def test_colmap_dense_io_matches_jax(tmp_path):
    """``write_array``/``read_array`` and ``read_fused`` (JAX
    ``tests/test_data_io.py``' fixtures) equal JAX's."""
    from depth_lidar_nerf_tpu.data import colmap_dense as jd
    from depth_lidar_nerf_tpu_torch.data import colmap_dense as td

    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 10, (12, 17)).astype(np.float32)
    jd.write_array(depth, str(tmp_path / "j.bin"))
    td.write_array(depth, str(tmp_path / "t.bin"))
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    assert np.array_equal(td.read_array(str(tmp_path / "j.bin")), depth)

    n = 5
    xyz = rng.standard_normal((n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    ply, vis = tmp_path / "fused.ply", tmp_path / "fused.ply.vis"
    with open(ply, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for prop in ("x", "y", "z", "nx", "ny", "nz"):
            f.write(f"property float {prop}\n".encode())
        for prop in ("red", "green", "blue"):
            f.write(f"property uchar {prop}\n".encode())
        f.write(b"end_header\n")
        for i in range(n):
            f.write(xyz[i].tobytes() + nrm[i].tobytes() + rgb[i].tobytes())
    with open(vis, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<I", 2))
            f.write(np.array([i, i + 1], np.uint32).tobytes())
    got = td.read_fused(str(ply), str(vis))
    want = jd.read_fused(str(ply), str(vis))
    assert _fields([dict(enumerate(got))]) == _fields([dict(enumerate(want))])


def _sparse_scene(d):
    """A scene directory whose ``sparse/0`` holds a binary model of three
    views of a point cloud in front of them, every point seen by every view
    (written with the port's writers)."""
    rng = np.random.default_rng(1)
    cams = {1: tcm.Camera(1, 0, 40, 30, np.array([35.0, 20.0, 15.0]))}
    xyz = np.concatenate([rng.uniform(-1, 1, (60, 2)),
                          rng.uniform(3, 8, (60, 1))], axis=1)
    points, images = {}, {}
    for k, name in enumerate(("c.png", "a.png", "b.png")):
        iid = k + 1
        t = np.array([0.1 * k, -0.05 * k, 0.0])
        uv = (xyz[:, :2] + t[:2]) / (xyz[:, 2:] + t[2]) * 35.0 + [20.0, 15.0]
        ids = np.arange(1, 61, dtype=np.int64)
        ids[::7] = -1
        images[iid] = tcm.Image(iid, np.array([1.0, 0.0, 0.0, 0.0]), t, 1,
                                name, uv, ids)
    for p in range(60):
        points[p + 1] = tcm.Point3D(
            p + 1, xyz[p], np.array([1, 2, 3]), float(rng.uniform(0.1, 2)),
            np.array([1, 2, 3], np.int32), np.array([p, p, p], np.int32))
    sparse = os.path.join(d, "sparse", "0")
    tcm.write_model(cams, images, points, sparse, ext=".bin")
    return d


def test_colmap_pipeline_and_colmap_depth_match_jax(tmp_path):
    """``colmap_to_poses_bounds``, ``gen_poses`` on an existing model and
    ``load_colmap_depth`` on the written sparse model equal JAX's."""
    from depth_lidar_nerf_tpu.data import colmap_pipeline as jp
    from depth_lidar_nerf_tpu.data.depth import load_colmap_depth as jdepth
    from depth_lidar_nerf_tpu_torch.data import colmap_pipeline as tp
    from depth_lidar_nerf_tpu_torch.data.depth import \
        load_colmap_depth as tdepth

    d = _sparse_scene(str(tmp_path / "scene"))
    want = jp.colmap_to_poses_bounds(d)
    got = tp.colmap_to_poses_bounds(d)
    assert got.shape == (3, 17) and np.array_equal(got, want)
    assert tp.gen_poses(d)
    assert np.array_equal(np.load(os.path.join(d, "poses_bounds.npy")), want)
    for factor in (1, 2):
        a, b = tdepth(d, factor=factor), jdepth(d, factor=factor)
        assert len(a) == len(b) == 3 and sum(len(x["depth"]) for x in a) > 0
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert np.array_equal(x[k], y[k]), k


def test_run_colmap_calls_the_binary(tmp_path):
    """``run_colmap`` runs the ``colmap`` binary through ``subprocess`` as
    JAX's does: without it both raise the same ``FileNotFoundError`` after
    laying out ``sparse/`` and the log."""
    from depth_lidar_nerf_tpu.data import colmap_pipeline as jp
    from depth_lidar_nerf_tpu_torch.data import colmap_pipeline as tp

    errors = []
    for mod, name in ((jp, "j"), (tp, "t")):
        d = tmp_path / name
        (d / "images").mkdir(parents=True)
        with pytest.raises(FileNotFoundError) as e:
            mod.run_colmap(str(d), colmap_bin=str(tmp_path / "no_colmap"))
        errors.append(str(e.value).replace(f"/{name}/", "/"))
        assert (d / "sparse").is_dir() and (d / "colmap_output.txt").exists()
    assert errors[0] == errors[1]


def test_ray_dataset_matches_jax():
    """``RayDataset`` and ``epoch_batches`` give JAX's batches from one
    seed, with and without labels and ``drop_last``."""
    from depth_lidar_nerf_tpu.data import ray_dataset as jr
    from depth_lidar_nerf_tpu_torch.data import ray_dataset as tr

    rng = np.random.default_rng(0)
    rays = rng.standard_normal((100, 3, 3)).astype(np.float32)
    sem = rng.integers(0, 5, 100)
    for labels in (None, sem):
        for drop in (False, True):
            a = list(tr.epoch_batches(tr.RayDataset(rays, labels), 32,
                                      np.random.default_rng(7), drop))
            b = list(jr.epoch_batches(jr.RayDataset(rays, labels), 32,
                                      np.random.default_rng(7), drop))
            assert len(a) == len(b) == (3 if drop else 4)
            for x, y in zip(a, b):
                for u, v in zip(x if labels is not None else (x,),
                                y if labels is not None else (y,)):
                    assert np.array_equal(u, v)
    with pytest.raises(ValueError, match="align"):
        tr.RayDataset(rays, sem[:5])


def test_keras_import_matches_jax():
    """A Keras weight list loaded into the port's ``NeRFMLP`` gives JAX's
    output for the list loaded into its Flax tree, at rtol 1e-5."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.models import NeRFMLP as JMLP
    from depth_lidar_nerf_tpu.models.keras_import import \
        load_weights_from_keras as jload
    from depth_lidar_nerf_tpu_torch.models.keras_import import \
        load_weights_from_keras as tload
    from depth_lidar_nerf_tpu_torch.models.nerf_mlp import NeRFMLP as TMLP

    depth, width = 3, 16
    kw = dict(depth=depth, width=width, in_channels=9, in_channels_views=6,
              skips=(1,))
    jm = JMLP(**kw)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 9)), jnp.zeros((1, 6)))
    rng = np.random.default_rng(0)
    ws = []
    for name in [f"trunk_{i}" for i in range(depth)] + [
            "feature", "views_0", "rgb", "sigma"]:
        k = params["params"][name]["kernel"].shape
        ws += [rng.standard_normal(k).astype(np.float32),
               rng.standard_normal((1, k[1])).astype(np.float32)]
    pe = rng.standard_normal((7, 9)).astype(np.float32)
    ve = rng.standard_normal((7, 6)).astype(np.float32)
    want = np.asarray(jm.apply(jload(params, ws, depth), jnp.asarray(pe),
                               jnp.asarray(ve)))
    tm = tload(TMLP(**kw), ws, depth)
    assert torch.equal(tm.trunk_0.weight, torch.from_numpy(ws[0].T.copy()))
    with torch.no_grad():
        got = tm(torch.from_numpy(pe), torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("layer", ["layer2", "layer4"])
def test_resnet18_features_match_jax(layer):
    """The port's ``ResNet18Features`` with a torchvision-style state dict
    (the live golden of ``tests/test_resnet_torch_golden.py``) against JAX's
    with the same dict, at rtol 1e-5 of the feature map's scale, and against
    the torchvision-topology golden itself."""
    import jax
    import jax.numpy as jnp

    from depth_lidar_nerf_tpu.models import resnet_features as jres
    from depth_lidar_nerf_tpu_torch.models import resnet_features as tres
    from test_resnet_torch_golden import _randomize, _TorchResNet18

    golden = _randomize(_TorchResNet18())
    sd = {k: v.numpy() for k, v in golden.state_dict().items()}
    x = np.random.default_rng(1).normal(size=(2, 32, 40, 3)).astype(
        np.float32)
    jnet = jres.ResNet18Features(output_layer=layer)
    variables = jres.load_torch_resnet18(
        jnet.init(jax.random.key(0), jnp.asarray(x)), sd)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    net = tres.load_torch_resnet18(tres.ResNet18Features(layer), sd).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        ref = golden(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                     upto=layer).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_visualization_matches_jax(tmp_path):
    """``depth_on_image``, ``masked_uv_depth`` and ``depth_to_colormap``
    give JAX's arrays; ``visualize_sigma`` and ``plot_poses_matplotlib``
    write their figures; the HTML report is JAX's, byte for byte."""
    pytest.importorskip("matplotlib")
    from depth_lidar_nerf_tpu.utils import html_report as jh
    from depth_lidar_nerf_tpu.utils import visualization as jv
    from depth_lidar_nerf_tpu_torch.utils import camera_viz as tc
    from depth_lidar_nerf_tpu_torch.utils import html_report as th
    from depth_lidar_nerf_tpu_torch.utils import visualization as tv

    rng = np.random.default_rng(0)
    image = rng.uniform(0, 1, (12, 16, 3))
    pts = {"coord": rng.uniform(-2, 18, (30, 2)),
           "depth": rng.uniform(1, 5, 30)}
    assert np.array_equal(tv.depth_on_image(pts, image),
                          jv.depth_on_image(pts, image))
    depth = rng.uniform(0, 4, (12, 16))
    assert np.array_equal(tv.masked_uv_depth(depth, pts["coord"]),
                          jv.masked_uv_depth(depth, pts["coord"]))
    assert np.array_equal(tv.depth_to_colormap(depth),
                          jv.depth_to_colormap(depth))
    f = tv.visualize_sigma(rng.uniform(0, 1, 20), np.linspace(2, 6, 20),
                           str(tmp_path / "sigma.png"))
    assert os.path.getsize(f) > 0
    poses = np.stack([np.eye(4)[:3]] * 2)
    poses[1, :, 3] = [0.5, 0.0, 0.0]
    f = tc.plot_poses_matplotlib(poses, str(tmp_path / "poses.png"),
                                 points=rng.normal(size=(50, 3)))
    assert os.path.getsize(f) > 0
    pages = []
    for mod, name in ((jh, "j"), (th, "t")):
        d = tmp_path / name
        d.mkdir()
        for i in range(2):
            (d / f"{i:03d}.png").write_bytes(b"")
        (d / "000_depth.png").write_bytes(b"")
        rep = mod.HTMLReport(str(d), "t<1>")
        rep.add_text("a & b")
        rep.save("extra.html")
        pages.append((open(mod.report_from_renders(
            str(d), "renders", [{"psnr": 20.5, "it": 3}, {"it": 4}])).read(),
            (d / "extra.html").read_text()))
    assert pages[0] == pages[1]
