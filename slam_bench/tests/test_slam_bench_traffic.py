"""The benchmark's frozen copies of the port's traffic and arithmetic,
held to the originals at small sizes (on the CPU; the originals are
imported here, in the tests only)."""
import numpy as np
import pytest
import torch

from slam_bench import scene
from slam_bench.ate import ate_rmse


def _camera(w=64, h=48):
    f = 0.58 * w
    return scene.Camera(w, h, f, f, (w - 1) / 2.0, (h - 1) / 2.0, 1000.0)


@pytest.mark.parametrize("step", [0.02, 0.05])
def test_box_room_matches_the_ports_synthetic_sequence(step):
    from gs_icp_slam_torch.datasets.synthetic import synthetic_sequence

    seq = synthetic_sequence(width=64, height=48, num_frames=5,
                             angular_step=step, trajectory="corner")
    path = scene.Path(phase_step=step, yaw_step=0.9 * step)
    rgb, depth, gt = scene.render_frames(
        _camera(), scene.Room(), path, 5, noise="none", quantize=False,
        seed=3, device=torch.device("cpu"))
    for i in range(5):
        fr = seq[i]
        np.testing.assert_allclose(gt[i], fr.gt_c2w, atol=1e-12)
        np.testing.assert_allclose(depth[i], fr.depth, rtol=1e-6)
        assert np.abs(rgb[i].astype(int) - fr.rgb.astype(int)).max() <= 1


def test_kinect_noise_and_quantisation():
    cam = _camera(320, 240)
    path = scene.Path(phase_step=0.02, yaw_step=0.018)
    kw = dict(quantize=True, device=torch.device("cpu"))
    _, clean, _ = scene.render_frames(cam, scene.Room(), path, 2,
                                      noise="none", seed=1, **kw)
    _, a, _ = scene.render_frames(cam, scene.Room(), path, 2,
                                  noise="kinect_v1", seed=1, **kw)
    _, b, _ = scene.render_frames(cam, scene.Room(), path, 2,
                                  noise="kinect_v1", seed=1, **kw)
    _, c, _ = scene.render_frames(cam, scene.Room(), path, 2,
                                  noise="kinect_v1", seed=2, **kw)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(np.round(a), a)      # whole raw units
    z = clean / cam.depth_scale
    sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
    ratio = ((a - clean) / cam.depth_scale / sigma).ravel()
    assert abs(ratio.std() - 1.0) < 0.05 and abs(ratio.mean()) < 0.05
    with pytest.raises(ValueError):
        scene.render_frames(cam, scene.Room(), path, 1, noise="tof", seed=1,
                            **kw)


def test_ate_matches_the_ports():
    from gs_icp_slam_torch.eval.ate import ate_rmse as port_ate

    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (30, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(30, 3))
    est = gt.copy()
    est[:, :3, 3] += 0.01 * rng.normal(size=(30, 3))
    assert ate_rmse(gt, est) == pytest.approx(port_ate(gt, est), rel=1e-12)
    assert ate_rmse(gt, gt) < 1e-12
