"""PyTorch port: the command line (gs_icp_slam_torch/cli.py, `python -m
gs_icp_slam_torch`) against the JAX package's: the flags, the config each
argv builds, and `run` / `render` / `eval` end to end at 128x96.

Both CLIs run the same synthetic `run` (6 frames, downsample 4, no eval,
--save_results) at tests/test_torch_fused.py's 128x96 (at 64x48 the 192
points of a frame leave G-ICP so loosely held that near-tie neighbour
picks moved a pose by 1.7 mm between the packages); the port on the CPU
with a replay of JAX's draws from PRNGKey(--seed).  The CLI has no render flags, so both packages'
synthetic_config are patched for the run to 16-pixel tiles, K <= 256 and
12-tile chunks of the JAX XLA compositor (as tests/test_torch_fused.py
configures it), which keeps the JAX CPU run cheap.

Tolerances, and why: flags, configs, results.json's keys and counts
exact; ATE within 1e-2 cm, trajectory.npy and scene.ply's positions and
colours within 1e-4 (the packages' float32 drift, as in
tests/test_torch_fused.py); opacity logits within 1e-3 (Adam's step
moves a parameter by up to its learning rate, 0.05 for opacity, whatever
the gradient's size, so the drift of a near-zero gradient moves it by a
fraction of a step: 3.5e-4 was seen); the Gaussians' covariances
R diag(s^2) R^T (not their log-scales and quaternions, which are
ill-conditioned on flat and near-isotropic neighbourhoods) within 1e-6 in
all but 3% of the rows (a near-tie neighbour pick of the k-NN seeds
another covariance: 28 of 1,600 rows were seen off, ROADMAP §3); the
port's render of a PLY within one uint8 level of JAX's render of it (the
same float32 image rounded); eval's PSNR/SSIM of identical inputs within
1e-4 of JAX's.
"""
import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import gs_icp_slam_tpu.config as jconfig
import gs_icp_slam_torch.config as tconfig
from gs_icp_slam_tpu import cli as jcli
from gs_icp_slam_tpu.eval.offline import render_ply_sequence
from gs_icp_slam_tpu.io.ply import load_ply as j_load_ply
from gs_icp_slam_torch import cli as tcli
from gs_icp_slam_torch.io import load_fused_state
from gs_icp_slam_torch.ops.covariance import quat_scale_to_cov
from test_torch_io import JaxDraws

W, H, FRAMES = 128, 96, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_args(cli, argv):
    ap = argparse.ArgumentParser()
    cli._build_run_parser(ap.add_subparsers(dest="cmd"))
    return ap.parse_args(["run", *argv])


def _caminfo(path, kind, w=1200, h=680):
    path.write_text("# cam\n# W H fx fy cx cy scale trunc type\n"
                    f"{w} {h} 600.0 600.0 {(w - 1) / 2} {(h - 1) / 2} "
                    f"6553.5 12.0 {kind}\n")
    return str(path)


@pytest.mark.parametrize("cmd", ["run", "render", "eval"])
def test_flags_match_jax(cmd, capsys):
    """Each subcommand's help (flags, defaults, choices, help strings)
    equals JAX's but for the program's name; run's parser actions equal
    JAX's one by one."""
    helps = []
    for cli, prog in ((jcli, "gs_icp_slam_tpu"),
                      (tcli, "gs_icp_slam_torch")):
        with pytest.raises(SystemExit) as e:
            cli.main([cmd, "--help"])
        assert e.value.code == 0
        # the usage lines wrap at the program name's length
        helps.append(" ".join(capsys.readouterr().out.replace(
            prog, "PROG").split()))
    assert helps[0] == helps[1]
    if cmd == "run":
        def actions(cli):
            ap = argparse.ArgumentParser()
            p = cli._build_run_parser(ap.add_subparsers(dest="cmd"))
            return [(a.option_strings, a.dest, a.default, a.type,
                     a.choices, a.const) for a in p._actions]
        assert actions(tcli) == actions(jcli)


_ARGVS = {
    "replica": ["--dataset_type", "replica"],
    "tum_kf_gicp": ["--dataset_type", "tum", "--keyframe_th", "0.9",
                    "--knn_maxd", "2.0", "--overlapped_th", "1e-3",
                    "--overlapped_th2", "2e-4"],
    "synthetic_map_opt": ["--dataset_type", "synthetic",
                          "--downsample_rate", "4",
                          "--max_correspondence_distance", "0.05",
                          "--motion_model", "constant_velocity",
                          "--init_opacity", "0.5", "--feature_lr", "1e-2",
                          "--trackable_opacity_th", "0.1"],
    "caminfo_engine": ["CAMINFO:replica", "--unlimited",
                       "--mapping_iters_per_frame", "2",
                       "--mapping_iters_final", "10", "--capacity", "262144",
                       "--training_stage", "1"],
    "caminfo_fps": ["CAMINFO:tum", "--fps_cap", "15"],
    "caminfo_overridden": ["CAMINFO:synthetic", "--dataset_type", "replica",
                           "--fps_cap", "10", "--unlimited"],
    "caminfo_synthetic": ["CAMINFO:synthetic", "--motion_model",
                          "adaptive"],
}


@pytest.mark.parametrize("name", list(_ARGVS))
def test_config_for_matches_jax(name, tmp_path):
    argv = []
    for a in _ARGVS[name]:
        if a.startswith("CAMINFO:"):
            argv += ["--config", _caminfo(tmp_path / "caminfo.txt",
                                          a.split(":")[1])]
        else:
            argv.append(a)
    t = tcli._config_for(_run_args(tcli, argv))
    j = jcli._config_for(_run_args(jcli, argv))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_config_for_needs_a_dataset_type():
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit):
            cli._config_for(_run_args(cli, []))


def _cheap_render(monkeypatch):
    for mod in (jconfig, tconfig):
        orig = mod.synthetic_config

        def patched(*a, _orig=orig, **kw):
            cfg = _orig(*a, **kw)
            return cfg.replace(render=dataclasses.replace(
                cfg.render, tile_size=16, composite_chunk=12,
                max_per_tile=256))

        monkeypatch.setattr(mod, "synthetic_config", patched)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' `run` on the same argv; the port's also writes a
    checkpoint and takes JAX's draws."""
    root = tmp_path_factory.mktemp("cli")
    caminfo = _caminfo(root / "caminfo.txt", "synthetic", W, H)
    argv = ["run", "--config", caminfo, "--dataset_type", "synthetic",
            "--frames", str(FRAMES), "--downsample_rate", "4", "--no_eval",
            "--save_results", "--unlimited"]
    mp = pytest.MonkeyPatch()
    _cheap_render(mp)
    draws = JaxDraws(jax.random.PRNGKey(0))
    try:
        assert jcli.main(argv + ["--output_path", str(root / "jax")]) == 0
        assert tcli.main(argv + ["--output_path", str(root / "torch"),
                                 "--checkpoint_path",
                                 str(root / "torch" / "ckpt.npz")],
                         device="cpu", draws=draws) == 0
    finally:
        mp.undo()
    return root, draws


def test_run_matches_jax(runs):
    root, draws = runs
    j, t = root / "jax", root / "torch"
    assert sorted(os.listdir(j)) == sorted(
        n for n in os.listdir(t) if n != "ckpt.npz")
    rj = json.loads((j / "results.json").read_text())
    rt = json.loads((t / "results.json").read_text())
    assert list(rt) == list(rj)
    assert abs(rt["ate_rmse_cm"] - rj["ate_rmse_cm"]) <= 1e-2
    for k in ("num_gaussians", "frames", "psnr", "ssim", "lpips", "config"):
        assert rt[k] == rj[k], k
    assert rt["frames"] == FRAMES and rt["fps"] > 0
    txt = (t / "results.txt").read_text().splitlines()
    assert txt[0].startswith("System FPS: ")
    assert txt[1].startswith("ATE RMSE: ") and txt[1].endswith(" cm")
    np.testing.assert_allclose(np.load(t / "trajectory.npy"),
                               np.load(j / "trajectory.npy"), atol=1e-4)
    np.testing.assert_array_equal(np.load(t / "trajectory_gt.npy"),
                                  np.load(j / "trajectory_gt.npy"))
    pj, pt = j_load_ply(str(j / "scene.ply")), j_load_ply(str(t / "scene.ply"))
    assert len(pt["xyz"]) == len(pj["xyz"]) == rt["num_gaussians"]
    for k in ("xyz", "f_dc"):
        np.testing.assert_allclose(pt[k], pj[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(pt["opacity_logit"], pj["opacity_logit"],
                               atol=1e-3)
    assert pt["f_rest"].shape == pj["f_rest"].shape

    def cov(p):
        return quat_scale_to_cov(torch.from_numpy(p["rotation"]),
                                 torch.exp(torch.from_numpy(
                                     p["log_scaling"]))).numpy()

    off = np.abs(cov(pt) - cov(pj)).max(axis=(1, 2)) > 1e-6
    assert off.mean() <= 0.03, off.sum()
    # the checkpoint: the final state, with the draws' position
    again = JaxDraws(jax.random.PRNGKey(1))
    st = load_fused_state(str(t / "ckpt.npz"), "cpu", again)
    assert st.frame_idx == FRAMES and st.gmap.num_live == rt["num_gaussians"]
    np.testing.assert_array_equal(np.asarray(again.key),
                                  np.asarray(draws.key))


def test_render_and_eval(runs, tmp_path, capsys):
    """The port's `render` of its scene.ply along its trajectory, against
    JAX's render_ply_sequence of the same file; `eval` of the renders
    against themselves (PSNR > 60, SSIM > 0.999, as
    tests/test_cli_eval.py requires) and against JAX's renders, equal to
    JAX's `eval` of the same directories."""
    from gs_icp_slam_torch.datasets import open_dataset

    root, _ = runs
    t = root / "torch"
    intr = open_dataset("synthetic", width=W, height=H, num_frames=1).intr
    tr, jr = tmp_path / "t", tmp_path / "j"
    assert tcli.main(["render", "--ply", str(t / "scene.ply"),
                      "--trajectory", str(t / "trajectory.npy"),
                      "--output_path", str(tr), "--width", str(W),
                      "--height", str(H), "--fx", str(intr.fx), "--fy",
                      str(intr.fy), "--stride", "2"], device="cpu") == 0
    assert capsys.readouterr().out.strip() == f"rendered 3 frames to {tr}"
    render_ply_sequence(str(t / "scene.ply"), np.load(t / "trajectory.npy"),
                        str(jr), W, H, intr.fx, intr.fy, stride=2)
    names = sorted(os.listdir(tr))
    assert names == sorted(os.listdir(jr)) == [
        "000000.png", "000002.png", "000004.png"]
    from PIL import Image
    for n in names:
        a = np.asarray(Image.open(tr / n)).astype(int)
        b = np.asarray(Image.open(jr / n)).astype(int)
        assert np.abs(a - b).max() <= 1, n
        assert a.std() > 5

    out = tmp_path / "self.json"
    assert tcli.main(["eval", "--renders", str(tr), "--gt", str(tr),
                      "--output_json", str(out)], device="cpu") == 0
    m = json.loads(out.read_text())
    assert m["mean"]["psnr"] > 60 and m["mean"]["ssim"] > 0.999
    assert sorted(m["per_view"]) == names
    capsys.readouterr()
    results = []
    for cli, kw in ((tcli, {"device": "cpu"}), (jcli, {})):
        assert cli.main(["eval", "--renders", str(tr), "--gt", str(jr)],
                        **kw) == 0
        results.append(json.loads(capsys.readouterr().out))
    for k in ("psnr", "ssim"):
        assert abs(results[0][k] - results[1][k]) <= 1e-4 * abs(results[1][k])
    assert results[0]["lpips"] is results[1]["lpips"] is None


def test_main_runs_on_the_gpu_unless_asked(tmp_path):
    """Without device="cpu", main runs on the GPU: where there is none it
    raises (through resolve_device) before doing anything."""
    d = tmp_path / "imgs"
    d.mkdir()
    from PIL import Image
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(d / "a.png")
    argv = ["eval", "--renders", str(d), "--gt", str(d)]
    if torch.cuda.is_available():
        assert tcli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(argv)
    assert tcli.main(argv, device="cpu") == 0
