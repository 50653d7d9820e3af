"""The device-interval union, the breakdown and every metric reader, on
hand-made events and on a profiler fixture recorded on the card: 40 ms
of a three-frame TUM episode of the port, from a K2 call to the next
opt step's K1-bwd (slam_bench/tests/fixtures/tum3_events.json)."""
from pathlib import Path

import numpy as np
import pytest

from slam_bench import run, trace as tr

FIXTURE = Path(__file__).parent / "fixtures" / "tum3_events.json"


def events(dev, host=(), t0=0, t1=100):
    """Events from (name, start, end) rows."""
    def split(rows):
        names = list(dict.fromkeys(r[0] for r in rows))
        arr = np.array([[names.index(r[0]), r[1], r[2]] for r in rows],
                       np.int64).reshape(-1, 3)
        return names, arr[:, 0], arr[:, 1], arr[:, 2]

    return tr.Events(*split(dev), *split(list(host)), t0=t0, t1=t1)


def test_union_and_busy():
    s, e = tr.union(np.array([5, 0, 12, 30]), np.array([10, 7, 20, 31]))
    assert s.tolist() == [0, 12, 30] and e.tolist() == [10, 20, 31]
    ev = events([("a", 0, 10), ("b", 5, 20), ("c", 90, 120)], t1=100)
    assert tr.busy_s(ev) == pytest.approx(30e-9)
    assert tr.union(np.zeros(0, np.int64), np.zeros(0, np.int64))[0].size == 0


def test_breakdown_names_ops_and_idle_gaps():
    ev = events([("void nn1_search(float const*)", 0, 10),
                 ("at::native::(anonymous namespace)::k<float>(int)", 40, 50)],
                host=[("aten::item", 12, 38),
                      ("cudaStreamSynchronize", 20, 30),
                      ("aten::mul", 55, 60)], t1=100)
    ops = dict(tr.device_ops(ev))
    assert ops == {"nn1_search": pytest.approx(10e-9),
                   "at::native::{anon}::k<float>": pytest.approx(10e-9)}
    gaps = dict(tr.idle_gaps(ev))
    # 10..40 lies in aten::item and, inside it, the stream sync at its
    # middle (25); 50..100 has no op at its middle (75)
    assert gaps == {"cudaStreamSynchronize": pytest.approx(30e-9),
                    "host: no op": pytest.approx(50e-9)}


def _rec(ev, frames=3, syncs=60):
    r = run.Record()
    r.setup_s = 12.5
    r.trace, r.trace_frames = ev, frames
    r.sync_count, r.sync_frames = syncs, frames
    r.episodes = [
        {"frames": 3, "seconds": 0.5, "latency_ms": [10.0, 20.0, 400.0]},
        {"frames": 3, "seconds": 0.25, "latency_ms": [5.0, 6.0, 7.0]}]
    return r


READERS = ["setup_s", "fps", "pose_ms_p95", "host_syncs_per_frame.replay",
           "host_syncs_per_frame.live", "launches_per_frame.replay",
           "k2_ms_per_frame.replay", "k1_ms_per_frame.replay",
           "device_idle_pct.replay", "device_busy_ms_per_frame.live"]


def test_every_metric_in_benchmark_json_has_a_reader_that_agrees():
    bench = run.load_json("BENCHMARK.json")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert sorted(names) == sorted(READERS)
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = run.load_reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m.get("moves")


def test_readers_on_hand_made_records():
    ev = events([("void nn1_search(float const*)", 0, 2_000_000),
                 ("composite_fwd_kernel(int const*)", 3_000_000, 4_000_000),
                 ("composite_bwd_walk(int const*)", 4_000_000, 6_000_000)],
                t1=10_000_000)
    r = _rec(ev, frames=2, syncs=41)
    val = {n: run.load_reader(n).read(r) for n in READERS}
    assert val["setup_s"] == 12.5
    assert val["fps"] == pytest.approx(6 / 0.75)
    assert val["pose_ms_p95"] == pytest.approx(np.percentile(
        [10, 20, 400, 5, 6, 7], 95))
    assert val["host_syncs_per_frame.replay"] == pytest.approx(20.5)
    assert val["launches_per_frame.replay"] == pytest.approx(1.5)
    assert val["k2_ms_per_frame.replay"] == pytest.approx(1.0)
    assert val["k1_ms_per_frame.replay"] == pytest.approx(1.5)
    assert val["device_idle_pct.replay"] == pytest.approx(50.0)
    assert val["device_busy_ms_per_frame.live"] == pytest.approx(2.5)


def test_readers_find_nothing_and_say_so():
    r = _rec(events([("void other(float)", 0, 10)]))
    assert run.load_reader("k2_ms_per_frame.replay").read(r) is None
    assert run.load_reader("k1_ms_per_frame.replay").read(r) is None
    r.trace = None
    assert run.load_reader("k2_ms_per_frame.replay").read(r) is None
    for n in ("launches_per_frame.replay", "device_idle_pct.replay",
              "device_busy_ms_per_frame.live"):
        assert run.load_reader(n).read(r) is None


def test_readers_on_the_recorded_fixture():
    ev = tr.load(FIXTURE)
    r = _rec(ev, frames=3)
    k2 = run.load_reader("k2_ms_per_frame.replay").read(r)
    k1 = run.load_reader("k1_ms_per_frame.replay").read(r)
    idle = run.load_reader("device_idle_pct.replay").read(r)
    busy = run.load_reader("device_busy_ms_per_frame.live").read(r)
    launches = run.load_reader("launches_per_frame.replay").read(r)
    assert 0 < k2 < busy and 0 < k1 < busy
    assert 0 < idle < 100
    assert busy * 3 == pytest.approx(tr.busy_s(ev) * 1e3)
    assert launches == ev.n_dev / 3
    assert len(tr.device_ops(ev)) == 10 and len(tr.idle_gaps(ev)) == 10
