"""Offline Scene loaders (counterpart of gs_icp_slam_tpu/datasets/scene.py,
numpy only) — the vanilla-3DGS `Scene` entry points the
reference keeps for its offline render/eval path (scene/__init__.py:22,
sceneLoadTypeCallbacks at scene/dataset_readers.py:420-423).

The reference's three readers, dispatched by `load_scene`:
  * "colmap": a COLMAP sparse model (cameras/images/points3D via
    io/colmap.py) — vanilla-3DGS training inputs.
  * "slam": a GS-ICP-SLAM-style capture directory (caminfo.txt +
    images/ + depth_images/, dataset_readers.py:314,190-234).  The
    reference fills identity poses (readSLAMCameras:201-202) and patches
    them from the tracker's final_pose afterwards; here poses.npy /
    poses.txt in the directory is honored when present.
  * "blender": NeRF-synthetic transforms_train.json captures
    (readNerfSyntheticInfo, dataset_readers.py:384-410).
  * auto: `load_scene(path)` picks by what exists on disk.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class CameraInfo:
    uid: int
    w2c: np.ndarray            # (4, 4) world-to-camera
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    image_path: str
    depth_path: Optional[str] = None
    depth_scale: float = 1.0
    # RGBA captures (NeRF-synthetic) composite onto this background when
    # loaded via load_camera_image; None = image is already opaque RGB.
    # The reference bakes this at read time (readCamerasFromTransforms,
    # scene/dataset_readers.py:342-366: arr = rgb*a + bg*(1-a)).
    bg_color: Optional[tuple] = None


def load_camera_image(cam: "CameraInfo") -> np.ndarray:
    """Decode a CameraInfo's image to (H, W, 3) uint8.

    RGBA images alpha-composite onto cam.bg_color (the reference does
    this at read time for Blender captures: rgb*a + bg*(1-a),
    scene/dataset_readers.py:342-366); black background if bg_color is
    unset.  Opaque images pass through unchanged."""
    from PIL import Image

    with Image.open(cam.image_path) as im:
        arr = np.asarray(im.convert("RGBA") if im.mode in ("RGBA", "LA", "PA",
                                                           "P") else im)
    if arr.ndim == 3 and arr.shape[2] == 4:
        rgb = arr[..., :3].astype(np.float32) / 255.0
        a = arr[..., 3:4].astype(np.float32) / 255.0
        bg = np.asarray(cam.bg_color if cam.bg_color is not None
                        else (0.0, 0.0, 0.0), np.float32)
        out = rgb * a + bg[None, None, :] * (1.0 - a)
        return (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        return np.stack([arr] * 3, axis=-1)
    return arr[..., :3]


@dataclass(frozen=True)
class SceneInfo:
    cameras: list
    points_xyz: Optional[np.ndarray] = None   # (N, 3)
    points_rgb: Optional[np.ndarray] = None   # (N, 3) uint8
    ply_path: Optional[str] = None


def load_colmap_scene(path: str, images_dir: str = "images") -> SceneInfo:
    """COLMAP capture: poses + intrinsics from sparse/0, image files from
    `images_dir` (readColmapSceneInfo parity)."""
    from ..io.colmap import load_colmap_model

    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams, imgs, xyz, rgb = load_colmap_model(sparse)
    infos = []
    for iid in sorted(imgs):
        im = imgs[iid]
        cam = cams[im.camera_id]
        infos.append(CameraInfo(
            uid=iid, w2c=im.w2c(), width=cam.width, height=cam.height,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            image_path=os.path.join(path, images_dir, im.name)))
    return SceneInfo(cameras=infos, points_xyz=xyz, points_rgb=rgb)


def load_slam_scene(path: str, images_dir: str = "images") -> SceneInfo:
    """GS-ICP-SLAM capture directory: caminfo.txt line 3 holds
    `W H fx fy cx cy depth_scale depth_trunc dataset_type`
    (configs/Replica/caminfo.txt, parsed at gs_icp_slam.py:52-62)."""
    with open(os.path.join(path, "caminfo.txt")) as f:
        lines = f.readlines()
    p = lines[2].split()
    width, height = int(p[0]), int(p[1])
    fx, fy, cx, cy = (float(v) for v in p[2:6])
    depth_scale = float(p[6])
    dataset_type = p[8] if len(p) > 8 else "replica"

    img_dir = os.path.join(path, images_dir)
    names = sorted(os.listdir(img_dir))
    poses = _load_poses(path, len(names))
    infos = []
    for i, name in enumerate(names):
        stem = name.split(".")[0]
        if dataset_type == "replica":
            depth_name = f"depth{stem[5:]}.png"  # frameXXXX -> depthXXXX
        else:
            depth_name = f"{stem}.png"
        dpath = os.path.join(path, "depth_images", depth_name)
        infos.append(CameraInfo(
            uid=i, w2c=poses[i], width=width, height=height,
            fx=fx, fy=fy, cx=cx, cy=cy,
            image_path=os.path.join(img_dir, name),
            depth_path=dpath if os.path.exists(dpath) else None,
            depth_scale=depth_scale))
    ply = os.path.join(path, "scene.ply")
    return SceneInfo(cameras=infos,
                     ply_path=ply if os.path.exists(ply) else None)


def load_blender_scene(path: str, white_background: bool = False,
                       extension: str = ".png",
                       include_test: bool = True,
                       seed: int = 0) -> SceneInfo:
    """NeRF-synthetic (Blender) capture: transforms_train.json holds
    camera_angle_x + per-frame camera-to-world matrices in OpenGL/Blender
    axes (Y up, Z back); flip Y/Z to the COLMAP/SLAM convention and invert
    to w2c (reference readCamerasFromTransforms,
    scene/dataset_readers.py:342-366).  With no COLMAP model, init points
    are 100k uniform samples of the scene bounds [-1.3, 1.3]^3
    (readNerfSyntheticInfo, dataset_readers.py:384-410); `seed` makes that
    deterministic here.  `include_test` mirrors the reference's
    eval=False default of folding transforms_test.json into training.
    `white_background` sets each camera's bg_color so load_camera_image
    alpha-composites RGBA NeRF-synthetic PNGs the way the reference bakes
    them at read time (dataset_readers.py:342-366)."""
    import json

    bgc = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)

    def read_transforms(fname):
        tpath = os.path.join(path, fname)
        if not os.path.exists(tpath):
            return []
        with open(tpath) as f:
            contents = json.load(f)
        fovx = float(contents["camera_angle_x"])
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            img_rel = frame["file_path"] + extension
            image_path = os.path.join(path, img_rel)
            c2w = np.asarray(frame["transform_matrix"], np.float64)
            c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP camera axes
            w2c = np.linalg.inv(c2w)
            width, height = _image_size(image_path)
            # fov -> pixel focal: fx from camera_angle_x and width; square
            # pixels (fov2focal, utils/graphics_utils.py)
            fx = width / (2.0 * np.tan(fovx / 2.0))
            infos.append(CameraInfo(
                uid=idx, w2c=w2c, width=width, height=height,
                fx=fx, fy=fx, cx=width / 2.0, cy=height / 2.0,
                image_path=image_path, bg_color=bgc))
        return infos

    cams = read_transforms("transforms_train.json")
    if include_test:
        cams = cams + read_transforms("transforms_test.json")
    ply = os.path.join(path, "points3d.ply")
    if os.path.exists(ply):
        return SceneInfo(cameras=cams, ply_path=ply)
    rng = np.random.default_rng(seed)
    num_pts = 100_000
    xyz = (rng.random((num_pts, 3)) * 2.6 - 1.3).astype(np.float32)
    rgb = rng.integers(0, 256, (num_pts, 3)).astype(np.uint8)
    return SceneInfo(cameras=cams, points_xyz=xyz, points_rgb=rgb)


def _image_size(image_path: str) -> tuple:
    """(width, height) of a PNG/JPEG without decoding pixel data; falls
    back to a PIL open for other formats."""
    import struct

    try:
        with open(image_path, "rb") as f:
            head = f.read(26)
        if head.startswith(b"\x89PNG\r\n\x1a\n"):
            w, h = struct.unpack(">II", head[16:24])
            return int(w), int(h)
    except OSError:
        pass
    from PIL import Image
    with Image.open(image_path) as im:
        return im.size


def _load_poses(path: str, n: int) -> np.ndarray:
    """poses.npy / poses.txt (c2w, one 4x4 per frame) if saved by a run;
    identity otherwise (the reference's readSLAMCameras default)."""
    npy = os.path.join(path, "poses.npy")
    txt = os.path.join(path, "poses.txt")
    if os.path.exists(npy):
        c2w = np.load(npy)
    elif os.path.exists(txt):
        c2w = np.loadtxt(txt).reshape(-1, 4, 4)
    else:
        return np.tile(np.eye(4), (n, 1, 1))
    w2c = np.linalg.inv(c2w)
    return w2c[:n]


def load_scene(path: str, kind: Optional[str] = None, **kw) -> SceneInfo:
    """Auto-dispatch like sceneLoadTypeCallbacks: COLMAP if a sparse/
    model exists, SLAM if caminfo.txt does."""
    if kind is None:
        if (os.path.isdir(os.path.join(path, "sparse"))):
            kind = "colmap"
        elif os.path.exists(os.path.join(path, "caminfo.txt")):
            kind = "slam"
        elif os.path.exists(os.path.join(path, "transforms_train.json")):
            kind = "blender"
        else:
            raise FileNotFoundError(
                f"{path}: no sparse/ (COLMAP), caminfo.txt (SLAM), or "
                f"transforms_train.json (Blender)")
    if kind == "colmap":
        return load_colmap_scene(path, **kw)
    if kind == "slam":
        return load_slam_scene(path, **kw)
    if kind == "blender":
        return load_blender_scene(path, **kw)
    raise ValueError(kind)
