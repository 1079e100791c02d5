"""Camera-frustum and ray 3D export (the port's copy of
``utils/camera_viz.py``).

Role of the reference's open3d viewers (``visualize_cameras.py:8-53``,
``run_nerf.py:1048-1101`` --render_test_ray): geometry is exported as ASCII
PLY line sets and point clouds, openable in MeshLab, CloudCompare or open3d.
Pure numpy; :func:`plot_poses_matplotlib` imports matplotlib when called.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def frustum_lines(c2w: np.ndarray, frustum_length: float = 0.5,
                  fov_deg: float = 50.0):
    """8 line segments sketching one camera frustum (visualize_cameras.py:8-27)."""
    half = frustum_length * np.tan(np.deg2rad(fov_deg) / 2.0)
    corners_cam = np.array([
        [-half, -half, -frustum_length],
        [half, -half, -frustum_length],
        [half, half, -frustum_length],
        [-half, half, -frustum_length],
    ])
    R, t = c2w[:3, :3], c2w[:3, 3]
    corners = corners_cam @ R.T + t
    pts = np.concatenate([t[None], corners], axis=0)  # 0=center, 1..4 corners
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return pts, segs


def write_ply_lines(path: str, points: np.ndarray, edges: Sequence[Tuple[int, int]],
                    color=(255, 128, 0)):
    """ASCII PLY with vertices + edge elements."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]} {color[0]} {color[1]} {color[2]}\n")
        for a, b in edges:
            f.write(f"{a} {b}\n")


def write_ply_points(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    points = np.asarray(points)
    if colors is None:
        colors = np.full((len(points), 3), 200, np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n")


def export_camera_frustums(poses: np.ndarray, out_path: str,
                           frustum_length: float = 0.5):
    """All-poses frustum lineset -> one PLY (visualize_cameras.py:30-53)."""
    all_pts: List[np.ndarray] = []
    all_edges: List[Tuple[int, int]] = []
    off = 0
    for c2w in poses:
        pts, segs = frustum_lines(np.asarray(c2w))
        all_pts.append(pts)
        all_edges.extend([(a + off, b + off) for a, b in segs])
        off += len(pts)
    write_ply_lines(out_path, np.concatenate(all_pts), all_edges)
    return out_path


def export_depth_rays(rays_o: np.ndarray, rays_d: np.ndarray,
                      depths: np.ndarray, out_path: str, max_rays: int = 2000):
    """Depth-supervised rays as segments origin -> origin + depth*dir
    (run_nerf.py:1078-1090 parity)."""
    n = min(max_rays, len(rays_o))
    pts, edges = [], []
    for i in range(n):
        a = rays_o[i]
        b = rays_o[i] + depths[i] * rays_d[i]
        pts.extend([a, b])
        edges.append((2 * i, 2 * i + 1))
    write_ply_lines(out_path, np.asarray(pts), edges, color=(255, 64, 64))
    return out_path


def plot_poses_matplotlib(poses: np.ndarray, out_path: str,
                          points: np.ndarray | None = None):
    """Static 3D snapshot (pose sanity check, poses_test.py role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for c2w in poses:
        pts, segs = frustum_lines(np.asarray(c2w))
        for a, b in segs:
            ax.plot(*zip(pts[a], pts[b]), c="tab:orange", lw=0.8)
    if points is not None and len(points):
        sub = points[:: max(1, len(points) // 5000)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.5, c="tab:red")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
