"""PyTorch port: the dataset loaders (Replica, TUM, the open_dataset
factory, the offline Scene loaders with the COLMAP reader), parse_caminfo
and the camera helpers, against the JAX package's, on files the tests
write (tests/test_datasets.py's and tests/test_scene.py's fixtures).

Tolerances, and why: frames, poses, lengths, intrinsics and scene cameras
exact (both packages decode the same files with the same numpy code);
TUM poses from random quaternions within 1e-6 (the rotation is computed
in float32 by torch here and by XLA there); the camera helpers exact.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from gs_icp_slam_tpu import config as jconfig
from gs_icp_slam_tpu import datasets as jds
from gs_icp_slam_tpu.datasets import scene as jscene
from gs_icp_slam_tpu.datasets import tum as jtum
from gs_icp_slam_tpu.io import colmap as jcolmap
from gs_icp_slam_tpu.utils import camera as jcam
from gs_icp_slam_torch import config as tconfig
from gs_icp_slam_torch import datasets as tds
from gs_icp_slam_torch.datasets import scene as tscene
from gs_icp_slam_torch.datasets import tum as ttum
from gs_icp_slam_torch.io import colmap as tcolmap
from gs_icp_slam_torch.utils import camera as tcam
from test_datasets import _write_replica_fixture, _write_tum_fixture
from test_scene import _write_colmap_bin, _write_png


def _same_sequences(a, b):
    assert len(a) == len(b)
    assert dataclasses.asdict(a.intr) == dataclasses.asdict(b.intr)
    for i in range(len(a)):
        fa, fb = a[i], b[i]
        np.testing.assert_array_equal(fa.rgb, fb.rgb)
        np.testing.assert_array_equal(fa.depth, fb.depth)
        assert fa.depth.dtype == fb.depth.dtype == np.float32
        np.testing.assert_array_equal(fa.gt_c2w, fb.gt_c2w)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)


@pytest.mark.parametrize("max_frames", [None, 2])
def test_replica_loader_matches_jax(tmp_path, max_frames):
    _write_replica_fixture(tmp_path)
    a = jds.ReplicaSequence(str(tmp_path), max_frames=max_frames)
    b = tds.ReplicaSequence(str(tmp_path), max_frames=max_frames)
    assert len(b) == (3 if max_frames is None else 2)
    _same_sequences(a, b)
    np.testing.assert_array_equal(b.poses, a.poses)
    assert tds.replica.REPLICA_INTR == tcam.Intrinsics(
        **dataclasses.asdict(jds.replica.REPLICA_INTR))


@pytest.mark.parametrize("max_frames", [None, 3])
def test_tum_loader_matches_jax(tmp_path, max_frames):
    _write_tum_fixture(tmp_path)
    a = jds.TumSequence(str(tmp_path), max_frames=max_frames)
    b = tds.TumSequence(str(tmp_path), max_frames=max_frames)
    assert 3 <= len(b) <= 7
    _same_sequences(a, b)
    assert b.color_paths == a.color_paths and b.depth_paths == a.depth_paths


def test_tum_association_and_pose_from_tq():
    rng = np.random.default_rng(0)
    t_img = np.sort(rng.random(40)) * 10
    t_dep = t_img + rng.normal(0, 0.05, 40)
    t_pose = np.sort(rng.random(60)) * 10
    assert (ttum.associate_frames(t_img, t_dep, t_pose)
            == jtum.associate_frames(t_img, t_dep, t_pose))
    for _ in range(8):
        pvec = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
        np.testing.assert_allclose(ttum.pose_from_tq(pvec),
                                   jtum.pose_from_tq(pvec), atol=1e-6)


def test_open_dataset_factory(tmp_path):
    _write_replica_fixture(tmp_path / "r")
    _write_tum_fixture(tmp_path / "t")
    for kind, path in (("replica", tmp_path / "r"), ("tum", tmp_path / "t")):
        b = tds.open_dataset(kind, str(path), max_frames=2)
        assert isinstance(b, {"replica": tds.ReplicaSequence,
                              "tum": tds.TumSequence}[kind])
        _same_sequences(jds.open_dataset(kind, str(path), max_frames=2), b)
    _same_sequences(jds.open_dataset("synthetic", width=32, height=24,
                                     num_frames=2),
                    tds.open_dataset("synthetic", width=32, height=24,
                                     num_frames=2))
    with pytest.raises(ValueError):
        tds.open_dataset("nope")


@pytest.mark.parametrize("kind", ["replica", "tum", "synthetic"])
def test_parse_caminfo(tmp_path, kind):
    path = tmp_path / "caminfo.txt"
    path.write_text("## camera\n## W H fx fy cx cy scale trunc type\n"
                    f"1200 680 600.0 601.5 599.5 339.5 6553.5 12.0 {kind}\n")
    ti, tk = tconfig.parse_caminfo(str(path))
    ji, jk = jconfig.parse_caminfo(str(path))
    assert tk == jk == kind
    assert dataclasses.asdict(ti) == dataclasses.asdict(ji)


def _same_scene(a, b):
    assert len(a.cameras) == len(b.cameras)
    for ca, cb in zip(a.cameras, b.cameras):
        for f in dataclasses.fields(ca):
            x, y = getattr(ca, f.name), getattr(cb, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    for f in ("points_xyz", "points_rgb"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.ply_path == b.ply_path


def test_colmap_binary_and_text_match_jax(tmp_path):
    d = str(tmp_path / "sparse" / "0")
    _write_colmap_bin(d)
    for name in ("cameras", "images"):
        rb = getattr(tcolmap, f"read_{name}_bin")(
            os.path.join(d, f"{name}.bin"))
        jb = getattr(jcolmap, f"read_{name}_bin")(
            os.path.join(d, f"{name}.bin"))
        assert rb.keys() == jb.keys()
        for k in rb:
            assert dataclasses.asdict(rb[k]).keys() == \
                dataclasses.asdict(jb[k]).keys()
    for k in (7, 8):
        imgs_t = tcolmap.read_images_bin(os.path.join(d, "images.bin"))
        imgs_j = jcolmap.read_images_bin(os.path.join(d, "images.bin"))
        np.testing.assert_array_equal(imgs_t[k].w2c(), imgs_j[k].w2c())
    dt = str(tmp_path / "txt")
    os.makedirs(dt)
    with open(os.path.join(dt, "cameras.txt"), "w") as f:
        f.write("# comment\n1 PINHOLE 640 480 500 510 320 240\n")
    with open(os.path.join(dt, "images.txt"), "w") as f:
        f.write("7 1 0 0 0 0.1 0.2 0.3 1 a.png\n\n")
    with open(os.path.join(dt, "points3D.txt"), "w") as f:
        f.write("1 1 2 3 10 20 30 0.5 7 0\n2 4 5 6 40 50 60 0.5 7 0\n")
    for model in (d, dt):
        t = tcolmap.load_colmap_model(model)
        j = jcolmap.load_colmap_model(model)
        assert t[0][1].fx == j[0][1].fx and t[0][1].model == j[0][1].model
        np.testing.assert_array_equal(t[1][7].w2c(), j[1][7].w2c())
        np.testing.assert_array_equal(t[2], j[2])
        np.testing.assert_array_equal(t[3], j[3])


def test_load_scene_colmap_and_slam_match_jax(tmp_path):
    from PIL import Image

    root = tmp_path / "capture"
    _write_colmap_bin(str(root / "sparse" / "0"))
    (root / "images").mkdir()
    _same_scene(tscene.load_scene(str(root)), jscene.load_scene(str(root)))
    assert len(tds.load_scene(str(root)).cameras) == 2

    run = tmp_path / "run"
    (run / "images").mkdir(parents=True)
    (run / "depth_images").mkdir()
    (run / "caminfo.txt").write_text(
        "# c\n# c\n64 48 60 60 31.5 23.5 1000.0 8.0 replica\n")
    for i in range(3):
        Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(
            run / "images" / f"frame{i:04d}.jpg")
        Image.fromarray(np.full((48, 64), 1000, np.uint16)).save(
            run / "depth_images" / f"depth{i:04d}.png")
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, 0, 3] = [0.0, 0.1, 0.2]
    np.save(run / "poses.npy", poses)
    _same_scene(tscene.load_scene(str(run)), jscene.load_scene(str(run)))
    with pytest.raises(FileNotFoundError):
        tscene.load_scene(str(tmp_path / "nothing"))


@pytest.mark.parametrize("white", [True, False])
def test_load_scene_blender_matches_jax(tmp_path, white):
    """Blender captures: the OpenGL -> COLMAP axis flip, fov -> focal, the
    seeded init cloud, and RGBA images composited onto the background."""
    import json

    from PIL import Image

    d = tmp_path / "lego"
    (d / "train").mkdir(parents=True)
    c2w = np.eye(4)
    c2w[2, 3] = 2.0
    meta = {"camera_angle_x": 0.8,
            "frames": [{"file_path": "./train/r_0",
                        "transform_matrix": c2w.tolist()},
                       {"file_path": "./train/r_1",
                        "transform_matrix": np.eye(4).tolist()}]}
    (d / "transforms_train.json").write_text(json.dumps(meta))
    _write_png(str(d / "train" / "r_0.png"), w=8, h=6)
    rgba = np.zeros((6, 8, 4), np.uint8)
    rgba[..., 0] = 200
    rgba[..., 3] = 128
    Image.fromarray(rgba).save(str(d / "train" / "r_1.png"))
    t = tscene.load_scene(str(d), kind="blender", white_background=white)
    j = jscene.load_scene(str(d), kind="blender", white_background=white)
    _same_scene(t, j)
    for ct, cj in zip(t.cameras, j.cameras):
        np.testing.assert_array_equal(tscene.load_camera_image(ct),
                                      jscene.load_camera_image(cj))


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(2)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    T = tcam.world_to_view(R, t)
    assert T.dtype == torch.float32 and T.device.type == "cpu"
    np.testing.assert_array_equal(T.numpy(),
                                  np.asarray(jcam.world_to_view(R, t)))
    T64 = tcam.world_to_view(torch.from_numpy(R.astype(np.float64)),
                             torch.from_numpy(t.astype(np.float64)))
    assert T64.dtype == torch.float64
    np.testing.assert_array_equal(
        tcam.gl_projection_matrix(0.01, 100.0, 1.2, 0.9),
        jcam.gl_projection_matrix(0.01, 100.0, 1.2, 0.9))
    intr = tcam.Intrinsics(64, 48, 60.0, 61.0, 31.5, 23.5)
    w2c = torch.from_numpy(np.array(jcam.world_to_view(R, t)))
    cam = tcam.Camera(intr, w2c)
    jc = jcam.Camera(jcam.Intrinsics(**dataclasses.asdict(intr)),
                     jcam.world_to_view(R, t))
    np.testing.assert_allclose(cam.c2w.numpy(), np.asarray(jc.c2w),
                               atol=1e-6)
    np.testing.assert_allclose(cam.center.numpy(), np.asarray(jc.center),
                               atol=1e-6)
    np.testing.assert_allclose(cam.c2w.numpy() @ w2c.numpy(), np.eye(4),
                               atol=1e-5)
    assert math.isclose(tcam.fov2focal(tcam.focal2fov(60.0, 64), 64), 60.0)
