"""COLMAP dense-reconstruction I/O: depth/normal arrays and fused-ply vis
(the port's copy of ``depth_lidar_nerf_tpu/data/colmap_dense.py``).

Parity: ``colmapUtils/read_write_dense.py:40-88`` (the .bin photometric/
geometric depth array format: ``width&height&channels&`` ASCII header then
row-major float32) and the fused point-cloud visibility reader
(``colmapUtils/read_write_fused_vis.py:47-126``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


def read_array(path: str) -> np.ndarray:
    """Read a COLMAP dense array (.bin: 'W&H&C&' header + float32 data)."""
    with open(path, "rb") as f:
        header = b""
        amp = 0
        while amp < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"truncated dense header in {path}")
            header += c
            if c == b"&":
                amp += 1
        width, height, channels = (int(x) for x in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(), np.float32)
    arr = data.reshape((width, height, channels), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(arr: np.ndarray, path: str) -> None:
    a = np.asarray(arr, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        f.write(np.transpose(a, (1, 0, 2)).tobytes(order="F"))


@dataclass
class FusedPoint:
    position: np.ndarray
    color: np.ndarray
    normal: np.ndarray
    num_visible_images: int
    visible_image_idxs: np.ndarray


def read_fused(ply_path: str, vis_path: str):
    """Read fused.ply + fused.ply.vis (per-point visible-image lists)."""
    positions, colors, normals = _read_fused_ply(ply_path)
    with open(vis_path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n != len(positions):
            raise ValueError(f"vis count {n} != ply points {len(positions)}")
        points = []
        for i in range(n):
            (k,) = struct.unpack("<I", f.read(4))
            idxs = np.frombuffer(f.read(4 * k), np.uint32)
            points.append(FusedPoint(positions[i], colors[i], normals[i], k,
                                     idxs.copy()))
    return points


def _read_fused_ply(path: str):
    with open(path, "rb") as f:
        n_vertex = 0
        fmt = "binary_little_endian"
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertex = int(line.split()[-1])
            elif line == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported ply format {fmt}")
        # x y z nx ny nz (f32) + r g b (u8)
        rec = np.dtype([("xyz", np.float32, 3), ("n", np.float32, 3),
                        ("rgb", np.uint8, 3)])
        data = np.frombuffer(f.read(rec.itemsize * n_vertex), rec)
    return data["xyz"].copy(), data["rgb"].copy(), data["n"].copy()
