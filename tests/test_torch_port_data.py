"""The driver's host side against the JAX package: the port's PNG codec,
``load_scene`` (LLFF with every split rule, spherify, a prebuilt pyramid),
the DTU loader without OpenCV, the pose utilities, the metrics, the depth
colour map and the PLY exports. Scenes are written by JAX's ``make_scene``
(through PIL), or by the port's, which needs no imaging library."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

# ----------------------------------------------------------------- PNG codec


def _pil_png(path, arr, mode):
    from PIL import Image

    Image.fromarray(arr, mode).save(path)
    return path


def _images(seed=0, H=29, W=41):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    smooth = (np.stack([xx * 5, yy * 7, xx + 2 * yy, 3 * xx + yy], -1)
              % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    return smooth, noise


@pytest.mark.parametrize("kind", ["RGB", "RGBA", "L", "LA", "I;16", "P"])
@pytest.mark.parametrize("content", ["smooth", "noise"])
def test_png_decoder_matches_imageio(tmp_path, kind, content):
    """PNGs written by PIL (its adaptive filters pick all five types over
    these rows) decode exactly as imageio decodes them."""
    import imageio.v2 as imageio
    from PIL import Image

    from depth_lidar_nerf_tpu_torch.utils.images import read_png

    smooth, noise = _images()
    src = smooth if content == "smooth" else noise
    path = str(tmp_path / "x.png")
    if kind == "RGB":
        _pil_png(path, src[..., :3], "RGB")
    elif kind == "RGBA":
        _pil_png(path, src, "RGBA")
    elif kind == "L":
        _pil_png(path, src[..., 0], "L")
    elif kind == "LA":
        _pil_png(path, src[..., :2], "LA")
    elif kind == "I;16":
        a16 = (src[..., 0].astype(np.uint16) * 257 + src[..., 1]).astype(
            np.uint16)
        Image.fromarray(a16).save(path)
    else:
        im = Image.fromarray(src[..., 0] % 17, "P")
        im.putpalette(list(np.random.default_rng(1).integers(0, 256, 768)))
        im.save(path)
    got, want = read_png(path), np.asarray(imageio.imread(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _encode_png(img, filters, depth=8, interlace=0):
    """A test-side encoder that filters row ``y`` with ``filters[y % 5]``
    (PNG spec section 9, written from the spec independently of the port)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    bpp = C * depth // 8
    if depth == 16:
        rows = img.astype(">u2").view(np.uint8).reshape(H, -1).astype(np.int64)
    else:
        rows = img.reshape(H, -1).astype(np.int64)
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(H):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                         interlace))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels,depth", [(3, 8), (4, 8), (1, 8), (2, 8),
                                            (1, 16), (3, 16)])
def test_png_decoder_each_filter(tmp_path, ftype, channels, depth):
    """Every row filtered with one type, every colour type and depth: the
    decoder gives back the pixels encoded, and so does imageio (whose PIL
    backend keeps the high byte of 16-bit RGB)."""
    import imageio.v2 as imageio

    from depth_lidar_nerf_tpu_torch.utils.images import read_png

    rng = np.random.default_rng(ftype + 10 * channels + depth)
    hi = 65536 if depth == 16 else 256
    img = rng.integers(0, hi, (13, 17, channels)).astype(
        np.uint16 if depth == 16 else np.uint8)
    if channels == 1:
        img = img[..., 0]
    path = tmp_path / "f.png"
    path.write_bytes(_encode_png(img, [ftype], depth))
    np.testing.assert_array_equal(read_png(str(path)), img)
    want = img >> 8 if depth == 16 and channels > 1 else img
    np.testing.assert_array_equal(np.asarray(imageio.imread(str(path))), want)


def test_png_mixed_filters_interlace_and_other_formats(tmp_path, monkeypatch):
    from depth_lidar_nerf_tpu_torch.utils.images import (imread_rgb_float,
                                                         read_png)

    img = np.random.default_rng(5).integers(0, 256, (11, 9, 3), dtype=np.uint8)
    p = tmp_path / "m.png"
    p.write_bytes(_encode_png(img, [4, 1, 3, 0, 2]))
    np.testing.assert_array_equal(read_png(str(p)), img)
    p.write_bytes(_encode_png(img, [0], interlace=1))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(str(p))
    # JPEG goes through imageio or PIL, and names its format without both.
    from PIL import Image

    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(jpg)
    assert imread_rgb_float(jpg).shape == (11, 9, 3)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"\.jpg images needs imageio or PIL"):
        imread_rgb_float(jpg)


@pytest.mark.parametrize("filter_type", [0, 2])
@pytest.mark.parametrize("grey", [False, True])
def test_png_writer_roundtrip(tmp_path, filter_type, grey):
    import imageio.v2 as imageio

    from depth_lidar_nerf_tpu_torch.utils.images import read_png, write_png

    img = np.random.default_rng(3).integers(0, 256, (23, 31, 3), dtype=np.uint8)
    if grey:
        img = img[..., 1]
    path = write_png(str(tmp_path / "w.png"), img, filter_type)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    np.testing.assert_array_equal(read_png(path), img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "bad.png"), img.astype(np.float32))


def test_imread_rgb_float_matches_jax(tmp_path):
    from depth_lidar_nerf_tpu.utils.images import imread_rgb_float as jread
    from depth_lidar_nerf_tpu_torch.utils.images import imread_rgb_float

    smooth, noise = _images(2)
    cases = {"rgb": (smooth[..., :3], "RGB"), "rgba": (noise, "RGBA"),
             "l": (smooth[..., 0], "L"), "la": (noise[..., :2], "LA")}
    for name, (arr, mode) in cases.items():
        path = _pil_png(str(tmp_path / f"{name}.png"), arr, mode)
        got, want = imread_rgb_float(path), jread(path)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=name)
    a16 = (noise[..., 0].astype(np.uint16) * 251).astype(np.uint16)
    path = str(tmp_path / "g16.png")
    (tmp_path / "g16.png").write_bytes(_encode_png(a16, [4], 16))
    np.testing.assert_array_equal(imread_rgb_float(path), jread(path))


# ---------------------------------------------------------------- load_scene


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A scene written by JAX's ``make_scene`` (PIL PNGs), with a prebuilt
    ``images_2/`` pyramid made by JAX's ``minify``."""
    from depth_lidar_nerf_tpu.data.llff import minify
    from depth_lidar_nerf_tpu.data.synthetic import make_scene

    d = str(tmp_path_factory.mktemp("jscene"))
    make_scene(d, n_images=5, H=24, W=32, focal=30.0, n_depth_points=60,
               backdrop=True)
    minify(d, 2)
    return d


_SPLITS = {
    "llffhold": dict(llffhold=2),
    "holdout_default": dict(llffhold=0),
    "test_scene": dict(llffhold=0, test_scene=[1, 3]),
    "train_scene": dict(llffhold=0, test_scene=[4], train_scene=[0, 2, 4]),
    "negative_test": dict(llffhold=0, test_scene=[-1]),
    "spherify": dict(llffhold=0, test_scene=[2], spherify=True),
    "factor2": dict(llffhold=0, test_scene=[0], factor=2),
    "ndc": dict(llffhold=3, no_ndc=False),
}


@pytest.mark.parametrize("case", list(_SPLITS))
def test_load_scene_matches_jax(jax_scene, case):
    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.loop import load_scene as jload
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene

    kw = dict(datadir=jax_scene, dataset_type="llff", factor=0, no_ndc=True,
              colmap_depth=True, semantic_loss=True)
    kw.update(_SPLITS[case])
    ref, got = jload(JCfg(**kw)), load_scene(TrainConfig(**kw))
    np.testing.assert_array_equal(got.images, ref.images)
    for name in ("poses", "bds", "render_poses"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert got.hwf == ref.hwf
    np.testing.assert_allclose([got.near, got.far], [ref.near, ref.far],
                               rtol=1e-6)
    np.testing.assert_array_equal(got.i_train, ref.i_train)
    np.testing.assert_array_equal(got.i_test, ref.i_test)
    assert got.i_test.dtype == ref.i_test.dtype
    np.testing.assert_array_equal(got.segmentation, ref.segmentation)
    assert got.num_semantic_classes == ref.num_semantic_classes
    assert len(got.depth_gts) == len(ref.depth_gts)
    for a, b in zip(got.depth_gts, ref.depth_gts):
        for k in ("depth", "coord", "weight"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if case == "factor2":
        assert got.images.shape[1:3] == (12, 16)


def test_port_scene_needs_no_imaging_library(tmp_path, monkeypatch):
    """The port's ``make_scene`` writes the pixels JAX's writes (through
    PIL), and the port loads it with imageio and PIL unimportable."""
    import imageio.v2 as imageio

    from depth_lidar_nerf_tpu.data.synthetic import make_scene as jmake
    from depth_lidar_nerf_tpu_torch.data.synthetic import make_scene
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene

    kw = dict(n_images=3, H=10, W=14, focal=12.0, n_depth_points=20,
              backdrop=True)
    jmake(str(tmp_path / "jax"), **kw)
    expected = [np.asarray(imageio.imread(str(tmp_path / "jax" / "images" / f)))
                for f in sorted(os.listdir(tmp_path / "jax" / "images"))]
    for mod in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    make_scene(str(tmp_path / "port"), **kw)
    monkeypatch.undo()
    got = [np.asarray(imageio.imread(str(tmp_path / "port" / "images" / f)))
           for f in sorted(os.listdir(tmp_path / "port" / "images"))]
    assert len(got) == len(expected) == 3
    for a, b in zip(got, expected):
        np.testing.assert_array_equal(a, b)
    for mod in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, mod, None)
    scene = load_scene(TrainConfig(datadir=str(tmp_path / "port"), factor=0,
                                   llffhold=0, colmap_depth=True, no_ndc=True))
    assert scene.images.shape == (3, 10, 14, 3)
    np.testing.assert_array_equal(scene.images[0],
                                  (expected[0] / 255.0).astype(np.float32))
    # A missing pyramid is never resized another way: it names the folder.
    with pytest.raises(RuntimeError, match="images_4 is missing"):
        load_scene(TrainConfig(datadir=str(tmp_path / "port"), factor=4))


def test_load_scene_dtu_matches_jax(tmp_path):
    """``load_dtu_data`` (scipy RQ) against JAX's (OpenCV) on cameras of
    known K, R and t, through ``load_scene``."""
    from scipy.spatial.transform import Rotation

    from depth_lidar_nerf_tpu.train.config import TrainConfig as JCfg
    from depth_lidar_nerf_tpu.train.loop import load_scene as jload
    from depth_lidar_nerf_tpu_torch.train.config import TrainConfig
    from depth_lidar_nerf_tpu_torch.train.loop import load_scene
    from depth_lidar_nerf_tpu_torch.utils.images import write_png

    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "image")
    cams, truth = {}, []
    for i in range(4):
        K = np.array([[300.0 + 10 * i, 0.5 * i, 16.0], [0.0, 290.0, 12.0],
                      [0.0, 0.0, 1.0]])
        R = Rotation.random(random_state=i).as_matrix()
        C = rng.normal(size=3)
        world = np.eye(4)
        world[:3] = 2.5 * K @ np.concatenate([R, -R @ C[:, None]], 1)
        scale = np.diag([1.5, 1.5, 1.5, 1.0])
        scale[:3, 3] = rng.normal(size=3) * 0.1
        cams[f"world_mat_{i}"], cams[f"scale_mat_{i}"] = world, scale
        truth.append((K, R, C, scale))
        write_png(str(tmp_path / "image" / f"{i:06d}.png"),
                  rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
    np.savez(tmp_path / "cameras.npz", **cams)
    kw = dict(datadir=str(tmp_path), dataset_type="dtu", test_scene=[3])
    ref, got = jload(JCfg(**kw)), load_scene(TrainConfig(**kw))
    np.testing.assert_array_equal(got.images, ref.images)
    np.testing.assert_allclose(got.poses, ref.poses, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.render_poses, ref.render_poses, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.hwf, ref.hwf, rtol=1e-6)
    assert (got.near, got.far) == (ref.near, ref.far) == (0.1, 5.0)
    np.testing.assert_array_equal(got.i_train, ref.i_train)
    np.testing.assert_array_equal(got.i_test, ref.i_test)
    # The known cameras: focal K[0, 0]; the scaled camera's centre.
    assert got.hwf[2] == pytest.approx(truth[-1][0][0, 0], rel=1e-9)
    K, R, C, scale = truth[0]
    centre = np.linalg.solve(scale, np.append(C, 1.0))[:3]
    np.testing.assert_allclose(got.poses[0, :3, 3], centre, rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------- poses, metrics, colour map, PLYs


def test_pose_utilities_match_jax():
    from depth_lidar_nerf_tpu.data import poses as jp
    from depth_lidar_nerf_tpu_torch.data import poses as tp

    rng = np.random.default_rng(0)
    poses = []
    for i in range(6):
        f = rng.normal(size=3) + np.array([0, 0, 3.0])
        pose = tp.view_matrix(f, np.array([0, 1.0, 0.1]), rng.normal(size=3))
        poses.append(np.concatenate([pose, [[24.0], [32.0], [30.0]]], 1))
    poses = np.stack(poses)
    bds = rng.uniform(1, 5, (6, 2))
    pts = rng.normal(size=(10, 3))
    np.testing.assert_array_equal(tp.world_to_camera(pts, poses[0]),
                                  jp.world_to_camera(pts, poses[0]))
    np.testing.assert_array_equal(tp.average_pose(poses), jp.average_pose(poses))
    np.testing.assert_array_equal(tp.recenter_poses(poses),
                                  jp.recenter_poses(poses))
    c2w = jp.average_pose(poses)
    np.testing.assert_array_equal(
        tp.spiral_path(c2w, c2w[:3, 1], [0.3, 0.2, 0.1], 4.0, N=7),
        jp.spiral_path(c2w, c2w[:3, 1], [0.3, 0.2, 0.1], 4.0, N=7))
    for a, b in zip(tp.spherify_poses(poses, bds), jp.spherify_poses(poses, bds)):
        np.testing.assert_array_equal(a, b)


def test_metrics_and_colormap_match_jax():
    from depth_lidar_nerf_tpu.evaluation.metrics import psnr as jpsnr
    from depth_lidar_nerf_tpu.evaluation.metrics import ssim_np as jssim
    from depth_lidar_nerf_tpu.utils.visualization import \
        depth_to_colormap as jcm
    from depth_lidar_nerf_tpu_torch.evaluation.metrics import psnr, ssim_np
    from depth_lidar_nerf_tpu_torch.utils.visualization import depth_to_colormap

    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (20, 26, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert psnr(a, b) == jpsnr(a, b)
    assert psnr(a, a) == float("inf")
    assert ssim_np(a, b) == jssim(a, b)
    assert ssim_np(a[:7, :5], b[:7, :5]) == jssim(a[:7, :5], b[:7, :5])
    d = rng.uniform(0.5, 3, (9, 11))
    d[0, 0] = np.nan
    np.testing.assert_array_equal(depth_to_colormap(d), jcm(d))
    np.testing.assert_array_equal(depth_to_colormap(d, 1.0, 2.0),
                                  jcm(d, 1.0, 2.0))


def test_ply_exports_match_jax(tmp_path):
    from depth_lidar_nerf_tpu.utils import camera_viz as jv
    from depth_lidar_nerf_tpu_torch.utils import camera_viz as tv

    rng = np.random.default_rng(2)
    poses = rng.normal(size=(3, 3, 4))
    ro, rd = rng.normal(size=(2, 5, 3))
    depth = rng.uniform(1, 2, 5)
    pts = rng.normal(size=(4, 3))
    for mod, d in ((jv, tmp_path / "j"), (tv, tmp_path / "t")):
        os.makedirs(d)
        mod.export_camera_frustums(poses, str(d / "cameras.ply"))
        mod.export_depth_rays(ro, rd, depth, str(d / "rays.ply"), max_rays=4)
        mod.write_ply_points(str(d / "pts.ply"), pts)
    for name in ("cameras.ply", "rays.ply", "pts.ply"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()
