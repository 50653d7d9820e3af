"""The harness rehearsed on the CPU at a tiny size: the run's path, the
comparison that decides `correct`, its control and the faults it has to
catch, the refusal without a card, and the import boundary."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "slam_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "gs_icp_slam_tpu"}


def tiny_spec(traffic="replay-desk"):
    """tum-fr1's settings and limits at 160x120 with small capacities (the
    map large enough for run()'s capacity buckets to engage).  Of the
    episode's numbers only the opt-step count is held: at this size and
    four frames no planted fault moves the ATE (sound 7.4-8.4 mm; the pose
    left at its seed 19.5) or the keyframe and Gaussian counts (3-4 and
    3,720-4,960 with the seed) by three times their sound readings."""
    from slam_bench import run

    bench = run.load_json("BENCHMARK.json")
    cell = next(w for w in bench["workloads"]
                if w["config"] == "tum-fr1" and w["traffic"] == traffic)
    spec = run.cell_spec(bench, cell["name"])
    c = spec["config"]["slam_config"]
    c["intr"].update(width=160, height=120, fx=129.3, fy=129.1, cx=79.6,
                     cy=63.8)
    c["downsample_rate"] = 4
    c["map"]["capacity"] = 1 << 15
    c["engine"]["target_capacity"] = 1 << 14
    c["engine"]["keyframe_capacity"] = 16
    c["render"]["visible_capacity"] = 1 << 9
    spec["traffic"]["episode_frames"] = 4
    spec["episode_limits"], spec["episode_expect"] = {}, {}
    if traffic.startswith("live"):
        spec["traffic"]["rate"] = 50.0
    return spec


SEED = 2 ** 31 + 11


def measure(spec):
    from slam_bench import run

    torch.set_num_threads(2)
    return run.measure(spec, SEED, 0.0, 0, torch.device("cpu"))


def failed_checks(out):
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_and_its_control():
    from slam_bench import control

    out = measure(tiny_spec())
    assert out["correct"], out["checks"]
    assert out["attempted"] == 4 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"fps", "setup_s"}
    assert {"opt_steps_off", "map_slots", "pose_mm",
            "render_rms"} <= set(out["checks"])
    # the control (no TF32 on the CPU: bfloat16) in the program's place
    got = control.readings(tiny_spec(), SEED, torch.device("cpu"), "bf16")
    assert got["correct"], got["program"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(v > limits[k] for k, v in got["control"].items()), got


def test_episode_checks_hold_the_cells_limits():
    from types import SimpleNamespace

    from slam_bench import check, run

    spec = run.cell_spec(run.load_json("BENCHMARK.json"),
                         "replica-room.replay")
    lim, exp = spec["episode_limits"], spec["episode_expect"]
    b = SimpleNamespace(spec=spec, cfg=run.slam_config(spec["config"],
                                                       spec["traffic"]))
    n = spec["traffic"]["episode_frames"]
    sound = {"frames": n, "opt_steps": 3 * n, "ate_m": 1e-4,
             "keyframes": exp["keyframes"], "gaussians": exp["gaussians"],
             "map_slots_used": 115920}
    got = check.episode_checks(b, [sound, sound])
    assert set(got) == {"opt_steps_off", "ate_mm", "keyframes_off",
                        "gaussians_off", "map_slots"}
    assert all(c["value"] <= c["limit"] for c in got.values()), got
    bad = [dict(sound, opt_steps=3 * n - 3),
           dict(sound, ate_m=2 * lim["ate_mm"] * 1e-3),
           dict(sound, ate_m=None),
           dict(sound, keyframes=exp["keyframes"] + lim["keyframes_off"] + 1),
           dict(sound, gaussians=exp["gaussians"] - lim["gaussians_off"] - 1),
           dict(sound, map_slots_used=1 << 19)]
    for e in bad:
        got = check.episode_checks(b, [sound, e])
        assert any(c["value"] > c["limit"] for c in got.values()), e


def test_the_check_steps_with_run_s_buckets():
    from slam_bench import run

    spec = tiny_spec()
    b = run.setup(spec, SEED, torch.device("cpu"))
    run.run_episode(b)
    nb, tb = b.engine._pick_buckets(int(b.engine.state.gmap.n))
    assert nb is not None and tb is not None   # the sliced path is judged


def test_live_traffic_reports_the_latency_tail():
    out = measure(tiny_spec("live-desk"))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"pose_ms_p95", "setup_s"}
    assert out["metrics"]["pose_ms_p95"]["value"] > 0


@pytest.mark.parametrize("fault", ["pose_unchanged", "pose_altered",
                                   "mapping_unchanged", "half_image",
                                   "mapping_skipped_alternate"])
def test_faults_in_the_timed_path_come_out_incorrect(fault, monkeypatch):
    from gs_icp_slam_torch.slam import fused
    from slam_bench import faults

    for name, fn in faults.patches(fault):
        monkeypatch.setattr(fused, name, fn)
    out = measure(tiny_spec())
    assert not out["correct"]
    assert failed_checks(out), out["checks"]


def _run_main(cwd, *args):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "slam_bench.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


ARGS = ("--workload", "replica-room.replay", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0")


def test_without_a_card_the_run_refuses():
    p = _run_main(ROOT, *ARGS)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_bench_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_main(tmp_path, *ARGS)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_import_boundary():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        if "tests" in f.relative_to(BENCH).parts:
            continue
        assert not set(_imports(f)) & FORBIDDEN, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "gs_icp_slam_torch" not in set(_imports(f)), f
    # what the modules load when imported, and what a run holds at exit
    code = (
        "import sys, json, pkgutil, importlib, torch\n"
        "import slam_bench.reference.step, slam_bench.check\n"
        "ref = 'gs_icp_slam_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "from slam_bench.tests.test_slam_bench_harness import (tiny_spec,\n"
        "                                                     measure)\n"
        "import slam_bench\n"
        "for m in pkgutil.walk_packages(slam_bench.__path__, 'slam_bench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "out = measure(tiny_spec())\n"
        "from slam_bench.run import forbidden_modules\n"
        "print(json.dumps({'ref_imports_program': ref,\n"
        "                  'forbidden': forbidden_modules(),\n"
        "                  'correct': out['correct']}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"ref_imports_program": False, "forbidden": [],
                   "correct": True}


@pytest.mark.gpu
def test_on_the_card_sound_run_passes_and_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from slam_bench import control

    got = control.readings(tiny_spec(), SEED, torch.device("cuda", 0),
                           "tf32")
    assert got["correct"], got["program"]
    limits = tiny_spec()["config"]["limits"]
    assert any(v > limits[k] for k, v in got["control"].items())
