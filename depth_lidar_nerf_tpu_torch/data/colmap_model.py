"""Compact COLMAP model I/O: binary + text readers and writers (the port's
copy of ``depth_lidar_nerf_tpu/data/colmap_model.py``, numpy only).

Covers the full role of the reference's vendored
``colmapUtils/read_write_model.py`` (readers :178-478 and writers :202-478 in
the reference) — re-written from the COLMAP model format spec: cameras /
images / points3D in both ``.bin`` and ``.txt`` encodings, plus the
``read_model`` / ``write_model`` dispatch entry points.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params), per the COLMAP camera-model table.
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_CAMERA_PARAMS = {mid: n for mid, (_, n) in _CAMERA_MODELS.items()}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in _CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: int
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R):
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0] + (q[0] == 0))


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model, w, h = _read(f, "<iiQQ")
            params = np.array(_read(f, "<" + "d" * _CAMERA_PARAMS[model]))
            cams[cid] = Camera(cid, model, w, h, params)
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts), dtype=np.float64).reshape(-1, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].copy().view(np.int64)
            images[iid] = Image(iid, qvec, tvec, cam_id, name.decode(), xys, ids)
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<ddd"))
            rgb = np.array(_read(f, "<BBB"))
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(-1, 2)
            points[pid] = Point3D(pid, xyz, rgb, error, track[:, 0].copy(),
                                  track[:, 1].copy())
    return points


# ------------------------------------------------------------- binary writers

def _write(f, fmt, *vals):
    f.write(struct.pack(fmt, *vals))


def write_cameras_binary(cameras, path):
    with open(path, "wb") as f:
        _write(f, "<Q", len(cameras))
        for cam in cameras.values():
            _write(f, "<iiQQ", cam.id, cam.model, cam.width, cam.height)
            _write(f, "<" + "d" * len(cam.params), *map(float, cam.params))


def write_images_binary(images, path):
    with open(path, "wb") as f:
        _write(f, "<Q", len(images))
        for im in images.values():
            _write(f, "<i", im.id)
            _write(f, "<dddd", *map(float, im.qvec))
            _write(f, "<ddd", *map(float, im.tvec))
            _write(f, "<i", im.camera_id)
            f.write(im.name.encode() + b"\x00")
            _write(f, "<Q", len(im.point3D_ids))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                _write(f, "<ddq", float(x), float(y), int(pid))


def write_points3d_binary(points, path):
    with open(path, "wb") as f:
        _write(f, "<Q", len(points))
        for pt in points.values():
            _write(f, "<Q", pt.id)
            _write(f, "<ddd", *map(float, pt.xyz))
            _write(f, "<BBB", *map(int, pt.rgb))
            _write(f, "<d", float(pt.error))
            _write(f, "<Q", len(pt.image_ids))
            for iid, p2d in zip(pt.image_ids, pt.point2D_idxs):
                _write(f, "<ii", int(iid), int(p2d))


# --------------------------------------------------------------- text format

def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path):
    cams = {}
    for line in _data_lines(path):
        parts = line.split()
        cid = int(parts[0])
        model = _MODEL_NAME_TO_ID[parts[1]]
        cams[cid] = Camera(cid, model, int(parts[2]), int(parts[3]),
                           np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path):
    # Images with zero 2D points still occupy two lines (the points line is
    # empty), so the points line must be consumed raw — the comment/empty
    # filter would otherwise drop it and desync the header/points pairing.
    images = {}
    with open(path) as f:
        for line in f:
            head = line.strip()
            if not head or head.startswith("#"):
                continue
            h = head.split()
            iid = int(h[0])
            qvec = np.array([float(v) for v in h[1:5]])
            tvec = np.array([float(v) for v in h[5:8]])
            cam_id, name = int(h[8]), h[9]
            vals = f.readline().split()
            xys = np.array([float(v) for v in vals], float).reshape(-1, 3)[:, :2] \
                if vals else np.zeros((0, 2))
            ids = np.array([int(v) for v in vals[2::3]], np.int64)
            images[iid] = Image(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3d_text(path):
    points = {}
    for line in _data_lines(path):
        p = line.split()
        track = np.array([int(v) for v in p[8:]], np.int32).reshape(-1, 2)
        points[int(p[0])] = Point3D(
            int(p[0]), np.array([float(v) for v in p[1:4]]),
            np.array([int(v) for v in p[4:7]]), float(p[7]),
            track[:, 0].copy(), track[:, 1].copy())
    return points


def write_cameras_text(cameras, path):
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {_CAMERA_MODELS[cam.model][0]} {cam.width} "
                    f"{cam.height} {params}\n")


def write_images_text(images, path):
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)) + "\n")


def write_points3d_text(points, path):
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for pt in points.values():
            xyz = " ".join(repr(float(v)) for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            track = " ".join(f"{int(i)} {int(j)}"
                             for i, j in zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {repr(float(pt.error))} {track}\n")


# ------------------------------------------------------------------ dispatch

def read_model(path, ext=".bin"):
    """Read (cameras, images, points3D) from a COLMAP model directory."""
    import os
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3d_binary(os.path.join(path, "points3D.bin")))
    if ext == ".txt":
        return (read_cameras_text(os.path.join(path, "cameras.txt")),
                read_images_text(os.path.join(path, "images.txt")),
                read_points3d_text(os.path.join(path, "points3D.txt")))
    raise ValueError(f"unknown model extension {ext!r}")


def write_model(cameras, images, points3D, path, ext=".bin"):
    """Write a COLMAP model directory in binary or text encoding."""
    import os
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3d_binary(points3D, os.path.join(path, "points3D.bin"))
    elif ext == ".txt":
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3d_text(points3D, os.path.join(path, "points3D.txt"))
    else:
        raise ValueError(f"unknown model extension {ext!r}")
