"""COLMAP sparse-model reader (binary and text; counterpart of
gs_icp_slam_tpu/io/colmap.py, numpy only), for vanilla-3DGS scene
compatibility (reference scene/colmap_loader.py + readColmapSceneInfo,
scene/dataset_readers.py — that loader is itself COLMAP's published script;
this one is written directly against the COLMAP model format spec:
https://colmap.github.io/format.html).

Only the fields the 3DGS pipeline consumes are kept: camera intrinsics,
image poses (world-to-camera quaternion/translation) and the sparse RGB
point cloud.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# model_id -> (name, num_params); params layouts per COLMAP docs
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),    # f, cx, cy, k
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass(frozen=True)
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        # SIMPLE_* models share one focal length
        return float(self.params[1] if self.model == "PINHOLE"
                     else self.params[0])

    @property
    def cx(self) -> float:
        return float(self.params[2] if self.model == "PINHOLE"
                     else self.params[1])

    @property
    def cy(self) -> float:
        return float(self.params[3] if self.model == "PINHOLE"
                     else self.params[2])


@dataclass(frozen=True)
class ColmapImage:
    image_id: int
    qvec: np.ndarray   # (4,) wxyz world-to-camera rotation
    tvec: np.ndarray   # (3,) world-to-camera translation
    camera_id: int
    name: str

    def w2c(self) -> np.ndarray:
        w, x, y, z = self.qvec
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = self.tvec
        return T


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, f"<{np_}d"))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            q = np.asarray(_read(f, "<4d"))
            t = np.asarray(_read(f, "<3d"))
            cid = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.seek(24 * npts, os.SEEK_CUR)  # skip 2D points (x, y, id3d)
            out[iid] = ColmapImage(iid, q, t, cid, name.decode("utf-8"))
    return out


def read_points3d_bin(path: str):
    """-> (xyz (N,3) f64, rgb (N,3) u8)."""
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _read(f, "<Q")  # point id
            xyz.append(_read(f, "<3d"))
            rgb.append(_read(f, "<3B"))
            _read(f, "<d")  # reprojection error
            (tl,) = _read(f, "<Q")
            f.seek(8 * tl, os.SEEK_CUR)  # track (image_id, point2D_idx)
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(rgb, np.uint8).reshape(-1, 3))


def read_cameras_txt(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            out[cid] = ColmapCamera(cid, parts[1], int(parts[2]),
                                    int(parts[3]),
                                    np.asarray(parts[4:], np.float64))
    return out


def read_images_txt(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    for meta in lines[0::2]:  # every other line is the 2D point list
        p = meta.split()
        out[int(p[0])] = ColmapImage(
            int(p[0]), np.asarray(p[1:5], np.float64),
            np.asarray(p[5:8], np.float64), int(p[8]), p[9])
    return out


def read_points3d_txt(path: str):
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(v) for v in p[1:4]])
            rgb.append([int(v) for v in p[4:7]])
    return (np.asarray(xyz, np.float64).reshape(-1, 3),
            np.asarray(rgb, np.uint8).reshape(-1, 3))


def load_colmap_model(sparse_dir: str):
    """Load a COLMAP sparse model directory (binary preferred, text
    fallback — same probing order as the reference's readColmapSceneInfo).

    Returns (cameras dict, images dict, xyz, rgb); xyz/rgb are None when
    no points3D file exists.
    """
    def pick(stem):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        if os.path.exists(b):
            return b, True
        if os.path.exists(t):
            return t, False
        raise FileNotFoundError(f"{stem}.bin/.txt not in {sparse_dir}")

    p, binary = pick("cameras")
    cams = read_cameras_bin(p) if binary else read_cameras_txt(p)
    p, binary = pick("images")
    imgs = read_images_bin(p) if binary else read_images_txt(p)
    xyz = rgb = None
    try:
        p, binary = pick("points3D")
        xyz, rgb = (read_points3d_bin(p) if binary
                    else read_points3d_txt(p))
    except FileNotFoundError:
        pass
    return cams, imgs, xyz, rgb
