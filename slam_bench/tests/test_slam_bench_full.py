"""The cell tum-fr1-full.replay-desk-600 rehearsed on the CPU at the small
size of the harness's other tests: its configuration and traffic as the
benchmark reads them, cut to 160x120 and to capacities small enough that
the episode's map grows through the opt-step buckets into the whole map,
as the whole-length session does at 2^20 slots on the card.  A sound run
is correct; with G-ICP's pose left at its seed it is not.  Also the
program's keyframe spans, fused.insert and fused.export, as the
harness's trace reads them."""
import numpy as np
import pytest
import torch

from slam_bench import run, trace as tr

CELL = "tum-fr1-full.replay-desk-600"
SEED = 1782951290
CAP = 1 << 13


def tiny_spec():
    spec = run.cell_spec(run.load_json("BENCHMARK.json"), CELL)
    c = spec["config"]["slam_config"]
    c["intr"].update(width=160, height=120, fx=129.3, fy=129.1, cx=79.6,
                     cy=63.8)
    c["downsample_rate"] = 4
    c["map"]["capacity"] = CAP
    c["engine"]["target_capacity"] = CAP
    c["engine"]["keyframe_capacity"] = 16
    c["render"]["visible_capacity"] = 1 << 9
    spec["traffic"]["episode_frames"] = 5
    spec["episode_limits"], spec["episode_expect"] = {}, {}
    return spec


@pytest.fixture
def small_buckets(monkeypatch):
    from gs_icp_slam_torch.slam.fused import FusedEngine

    # buckets of 2^10 slots and up, so that the small map passes through
    # them to the whole map as the 2^20-slot one does from 2^14
    monkeypatch.setattr(FusedEngine, "MIN_BUCKET", 1 << 10)


def measure(spec, lines=None):
    torch.set_num_threads(2)
    return run.measure(spec, SEED, 0.0, 0, torch.device("cpu"),
                       stats=None if lines is None else lines.append)


def test_the_configuration_differs_from_tum_fr1_in_its_capacities():
    full = run.cell_spec(run.load_json("BENCHMARK.json"), CELL)
    desk = run.cell_spec(run.load_json("BENCHMARK.json"),
                         "tum-fr1.replay-desk")
    a, b = full["config"]["slam_config"], desk["config"]["slam_config"]
    assert a["map"].pop("capacity") == a["engine"].pop(
        "target_capacity") == 1 << 20
    b["map"].pop("capacity"), b["engine"].pop("target_capacity")
    assert a == b
    assert full["config"]["sensor"] == desk["config"]["sensor"]
    assert full["traffic"]["path"] == desk["traffic"]["path"]
    assert full["traffic"]["episode_frames"] == 600
    assert (full["traffic"]["loop"], full["traffic"]["fps_cap"]) == (
        "closed", None)
    names = {m["name"] for m in full["end_to_end"] + full["per_layer"]}
    assert {"fps", "setup_s", "k2_ms_per_frame.replay"} <= names


def test_sound_run_through_the_whole_map_is_correct(small_buckets):
    lines = []
    out = measure(tiny_spec(), lines)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 5 and out["failed"] == 0
    # the episode's map ran past half the capacity, into the whole map
    assert lines[-1]["map_slots_used"] > CAP // 2
    assert out["checks"]["map_slots"]["value"] < CAP


def test_whole_map_step_is_what_the_check_judges(small_buckets):
    b = run.setup(tiny_spec(), SEED, torch.device("cpu"))
    run.run_episode(b)
    n = int(b.engine.state.gmap.n)
    assert b.engine._pick_buckets(n) == (None, None)
    c = b.engine.fused.counters
    assert c["insert_dropped"] == c["export_dropped"] == 0


def test_pose_left_at_its_seed_is_not_correct(small_buckets, monkeypatch):
    from gs_icp_slam_torch.slam import fused
    from slam_bench import faults

    for name, fn in faults.patches("pose_unchanged"):
        monkeypatch.setattr(fused, name, fn)
    out = measure(tiny_spec())
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_keyframe_spans_are_in_the_trace(small_buckets):
    b = run.setup(tiny_spec(), SEED, torch.device("cpu"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        e = run.run_episode(b)
    ev = tr.from_profiler(prof, 0, 2 ** 62)
    names = np.array(ev.host_names)[ev.host_id]
    # one insert a keyframe; one export a tracking keyframe, at most
    n_ins = int((names == "fused.insert").sum())
    n_exp = int((names == "fused.export").sum())
    assert n_ins == e["keyframes"] > 0
    assert 0 < n_exp <= n_ins
