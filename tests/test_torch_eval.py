"""PyTorch port: evaluation (masked PSNR, SSIM, `evaluate_sequence`, LPIPS
alex and vgg, the LPIPS fixtures) against the JAX package's eval modules.

Inputs are seeded numpy renders over the synthetic sequence's frames and
random LPIPS weights (`make_random_weights`: no pretrained weights are in
the repo).  Tolerances: PSNR within 1e-5 dB and SSIM within 1e-6 (the
same float32 sums in another order; the SSIM blur is a depthwise conv2d
here and shifted adds there); LPIPS within rtol 1e-4 (two conv trunks in
float32, cuDNN/oneDNN against XLA's convolutions).
"""
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.eval import image_metrics as jim
from gs_icp_slam_tpu.eval import lpips_fixtures as jfix
from gs_icp_slam_torch.datasets import open_dataset as t_open_dataset
from gs_icp_slam_torch.eval import image_metrics as tim
from gs_icp_slam_torch.eval import lpips_fixtures as tfix

# the modules (each package's eval/__init__ exports the function lpips)
jlp = importlib.import_module("gs_icp_slam_tpu.eval.lpips")
tlp = importlib.import_module("gs_icp_slam_torch.eval.lpips")

W, H, FRAMES = 64, 48, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(i):
    """A seeded prediction for frame i, (3, H, W) float32 in [0, 1]."""
    return np.random.default_rng(100 + i).uniform(
        size=(3, H, W)).astype(np.float32)


def _gt(seq, i):
    fr = seq[i]
    return (np.ascontiguousarray(fr.rgb.transpose(2, 0, 1))
            .astype(np.float32) / 255.0,
            fr.depth.astype(np.float32) / seq.intr.depth_scale)


def test_masked_psnr_and_ssim_match_jax():
    seq = t_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    for i in range(FRAMES):
        pred, (img, depth) = _render(i), _gt(seq, i)
        depth[: H // 4] = 0.0  # a masked band
        jp = float(jim._masked_psnr(jnp.asarray(pred), jnp.asarray(img),
                                    jnp.asarray(depth)))
        tp = float(tim._masked_psnr(torch.as_tensor(pred),
                                    torch.as_tensor(img),
                                    torch.as_tensor(depth)))
        assert abs(tp - jp) <= 1e-5, (i, tp, jp)
        js = float(jim._ssim_val(jnp.asarray(pred), jnp.asarray(img)))
        ts = float(tim._ssim_val(torch.as_tensor(pred), torch.as_tensor(img)))
        assert abs(ts - js) <= 1e-6, (i, ts, js)


def test_evaluate_sequence_matches_jax(tmp_path, monkeypatch):
    """Stride 2 with LPIPS-alex on random weights and PNG dumps."""
    wpath = str(tmp_path / "w.npz")
    jlp.make_random_weights(wpath, seed=1, net="alex")
    monkeypatch.setenv("GS_LPIPS_WEIGHTS", wpath)
    jseq = j_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    tseq = t_open_dataset("synthetic", width=W, height=H, num_frames=FRAMES)
    jm = jim.evaluate_sequence(lambda i: jnp.asarray(_render(i)), jseq,
                               FRAMES, stride=2, depth_scale=1000.0,
                               dump_dir=str(tmp_path / "jax"), dump_every=2)
    tm = tim.evaluate_sequence(lambda i: torch.as_tensor(_render(i)), tseq,
                               FRAMES, stride=2, depth_scale=1000.0,
                               dump_dir=str(tmp_path / "torch"),
                               dump_every=2)
    assert tm.per_frame_psnr.shape == (3,) and tm.lpips is not None
    np.testing.assert_allclose(tm.per_frame_psnr, jm.per_frame_psnr,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.per_frame_ssim, jm.per_frame_ssim,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.per_frame_lpips, jm.per_frame_lpips,
                               rtol=1e-4)
    assert abs(tm.psnr - jm.psnr) <= 1e-5 and abs(tm.ssim - jm.ssim) <= 1e-6
    assert tm.summary().startswith("PSNR: ")
    dumps = sorted(os.listdir(tmp_path / "torch"))
    assert dumps == sorted(os.listdir(tmp_path / "jax"))
    assert len(dumps) == 3  # frames 0, 2, 4
    ext = os.path.splitext(dumps[0])[1]
    if ext == ".npy":
        a = np.load(tmp_path / "torch" / dumps[0])
        b = np.load(tmp_path / "jax" / dumps[0])
    else:
        from PIL import Image
        a = np.asarray(Image.open(tmp_path / "torch" / dumps[0]))
        b = np.asarray(Image.open(tmp_path / "jax" / dumps[0]))
    np.testing.assert_array_equal(a, b)
    # without weights LPIPS is left out
    monkeypatch.delenv("GS_LPIPS_WEIGHTS")
    assert tim.evaluate_sequence(lambda i: torch.as_tensor(_render(i)),
                                 tseq, FRAMES, stride=4).lpips is None


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net, tmp_path):
    path = str(tmp_path / f"{net}.npz")
    jlp.make_random_weights(path, seed=3, net=net)
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(2, 3, 64, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = np.asarray(jlp.lpips(jnp.asarray(a), jnp.asarray(b),
                                weights=path))
    got = tlp.lpips(torch.as_tensor(a), torch.as_tensor(b),
                    weights=path).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # LPIPS(x, x) = 0 for any weights, a single (3, H, W) image too
    assert float(tlp.lpips(torch.as_tensor(a[0]), torch.as_tensor(a[0]),
                           weights=path)[0]) == 0.0


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_make_random_weights_same_arrays(net, tmp_path):
    jlp.make_random_weights(str(tmp_path / "j.npz"), seed=2, net=net)
    tlp.make_random_weights(str(tmp_path / "t.npz"), seed=2, net=net)
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k])


def test_weights_path_and_availability(tmp_path, monkeypatch):
    monkeypatch.delenv("GS_LPIPS_WEIGHTS", raising=False)
    here = os.path.dirname(tlp.__file__)
    shipped = any(os.path.exists(os.path.join(here, f))
                  for f in ("lpips_alex.npz", "lpips_vgg.npz"))
    assert tlp.lpips_available() == shipped
    # a GS_LPIPS_WEIGHTS naming no file counts as unset
    monkeypatch.setenv("GS_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert tlp.lpips_available() == shipped
    if not shipped:
        assert tlp.default_weights_path() is None
        with pytest.raises(FileNotFoundError):
            tlp.lpips(torch.zeros(3, 64, 64), torch.zeros(3, 64, 64))
    path = str(tmp_path / "w.npz")
    tlp.make_random_weights(path)
    monkeypatch.setenv("GS_LPIPS_WEIGHTS", path)
    assert tlp.default_weights_path() == path and tlp.lpips_available()
    assert jlp.default_weights_path() == path  # the same rule as JAX's


@pytest.mark.parametrize("name", list(jfix.FIXTURE_NAMES))
def test_lpips_fixture_pairs_equal_jax(name):
    assert tfix.FIXTURE_NAMES == jfix.FIXTURE_NAMES
    for t, j in zip(tfix.fixture_pair(name), jfix.fixture_pair(name)):
        assert t.dtype == np.float32 and t.shape == (3, 64, 64)
        np.testing.assert_array_equal(t, j)
