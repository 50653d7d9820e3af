"""PyTorch port: the map and the G-ICP target at the capacities a whole
fr1/desk session needs (slam_bench/configs/tum-fr1-full.json: 2^20 slots
each).

- `FusedEngine._pick_buckets` at the exact thresholds of the 2^19 bucket
  and of the whole map and target.
- One `FusedStep.step` at n_bucket None, from a state whose map has
  grown past the last bucket into the whole map, against the plain
  reference of the benchmark (slam_bench/reference) on seeded draws, at
  160x120 with 2^13 slots, the comparison that decides the benchmark's
  `correct`, held to the configuration's own limits.  The depth carries
  0.2% noise, as a sensor's does: on the noiseless scene the walls are
  exactly planar, a neighbourhood's least covariance eigenvalue is
  rounding, and the log-scale it gives a new splat differs between two
  sound implementations by orders (param_rel 0.09 on one seed).
- An insert and an export past their capacities: the port's
  `add_gaussians` and `trackable_export` against the JAX package's; and
  an engine whose map and target overflow, its `insert_dropped` /
  `export_dropped` counters against the rows its inserts and exports
  left out.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.models import gaussian_map as jgm
from gs_icp_slam_torch.datasets import open_dataset
from gs_icp_slam_torch.models import gaussian_map as tgm
from gs_icp_slam_torch.slam import FusedEngine

CELL = "tum-fr1-full.replay-desk-600"
FULL = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf():
    from slam_bench import run

    spec = run.cell_spec(run.load_json("BENCHMARK.json"), CELL)
    return spec["config"], spec["traffic"]


def _full_engine():
    """The configuration as run (640x480, 12,416 points a frame, map and
    target of 2^20); no frame is stepped."""
    from slam_bench import run

    conf, traffic = _conf()
    cfg = run.slam_config(conf, traffic)
    assert cfg.map.capacity == cfg.engine.target_capacity == FULL
    return FusedEngine(None, cfg, device="cpu")


P = 12416   # the points of a 640x480 frame at downsample_rate 5


@pytest.mark.parametrize("n,want", [
    (FULL // 2 - 2 * P, (FULL // 2, FULL // 2)),  # both at their 2^19
    (FULL // 2 - 2 * P + 1, (None, FULL // 2)),   # the map: whole
    (FULL // 2 - P, (None, FULL // 2)),
    (FULL // 2 - P + 1, (None, None)),            # the target: whole
    (FULL // 4 - 2 * P, (FULL // 4, FULL // 4)),  # the 2^18 buckets
    (FULL - 1, (None, None)),
])
def test_pick_buckets_at_the_thresholds(n, want):
    eng = _full_engine()
    assert eng.filt.num_points == P
    assert eng._pick_buckets(n) == want


SMALL = 1 << 13
NOISE = 0.002


def _small_run(seed: int, frames: int, cap: int = SMALL,
               tcap: int = SMALL):
    """tum-fr1-full's settings on the port's synthetic sequence at
    160x120 with noisy depth (1,200 points a frame), a map of `cap` and a
    target of `tcap` slots, buckets from 2^10: run over `frames` frames
    with the benchmark's draws.  Returns (engine, its episode, the
    configuration dict, the draws)."""
    from slam_bench import run

    seq = open_dataset("synthetic", width=160, height=120,
                       num_frames=frames + 1, noise_depth=NOISE)
    conf, traffic = _conf()
    c = conf["slam_config"]
    c["intr"] = dataclasses.asdict(seq.intr)
    c["downsample_rate"] = 4
    c["map"]["capacity"] = cap
    c["engine"]["target_capacity"] = tcap
    c["engine"]["keyframe_capacity"] = 16
    c["render"]["visible_capacity"] = 1 << 9
    cfg = run.slam_config(conf, traffic)
    fr = [seq[i] for i in range(frames + 1)]
    ep = run.Episode(np.stack([f.rgb for f in fr]),
                     np.stack([f.depth for f in fr]),
                     np.stack([f.gt_c2w for f in fr]), frames)
    draws = run.Draws(seed)
    eng = FusedEngine(ep, cfg, device="cpu", draws=draws)
    eng.MIN_BUCKET = 1 << 10
    eng.run(eval_render=False)
    return eng, ep, conf, draws


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_whole_map_step_matches_the_reference(seed):
    from slam_bench import check

    frames = 6
    eng, ep, conf, draws = _small_run(seed, frames)
    n = int(eng.state.gmap.n)
    # the map has passed its last bucket: the step runs on the whole map
    # and the whole target, and no row was dropped on the way
    assert SMALL // 2 - 2 * eng.filt.num_points < n < SMALL
    assert eng._pick_buckets(n) == (None, None)
    c = eng.fused.counters
    assert c["insert_dropped"] == c["export_dropped"] == 0
    prog, before, log, frame = check.program_step(
        eng, frames, ep.rgb[frames], ep.depth[frames], draws,
        torch.device("cpu"))
    assert prog["n"] > n                 # the frame inserted its points
    ref = check.reference_step(before, frame, conf, log)
    nums = check.compare(prog, ref, before, conf)
    nums["render_rms"] = check._rms(
        prog["render"], check._render(prog["params"], prog["live"],
                                      check.G.invert_se3(prog["pose"]),
                                      conf))
    limits = conf["limits"]
    assert set(nums) == set(limits)
    bad = {k: (v, limits[k]) for k, v in nums.items() if not v <= limits[k]}
    assert not bad, bad


def _batch(rng, P_):
    return (rng.normal(size=(P_, 3)).astype(np.float32),
            rng.uniform(size=(P_, 3)).astype(np.float32),
            rng.normal(size=(P_, 4)).astype(np.float32),
            rng.uniform(0.01, 0.1, (P_, 3)).astype(np.float32),
            rng.uniform(0.5, 4.0, P_).astype(np.float32),
            rng.random(P_) > 0.3, rng.random(P_) > 0.2)


@pytest.mark.parametrize("cap,out_cap", [(64, 16), (96, 48), (40, 40)])
def test_drops_past_capacity_match_jax(cap, out_cap):
    rng = np.random.default_rng(cap)
    jm = jgm.empty_map(cap)
    tm = tgm.empty_map(cap, device="cpu")
    offered = 0
    for _ in range(4):  # the inserts overflow the capacity
        b = _batch(rng, 40)
        offered += int(b[-1].sum())
        jm = jgm.add_gaussians(jm, *[jnp.asarray(a) for a in b],
                               init_opacity=0.3)
        tm = tgm.add_gaussians(tm, *[torch.as_tensor(a) for a in b],
                               init_opacity=0.3)
    assert tm.n == int(jm.n) == cap < offered
    for f in ("xyz", "f_dc", "log_scaling", "rotation", "opacity_logit",
              "trackable", "live"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    tm.opacity_logit[::5] = -5.0   # below the export threshold
    jm = jm._replace(opacity_logit=jnp.asarray(tm.opacity_logit.numpy()))
    je = jgm.trackable_export(jm, 0.05, out_cap)
    te = tgm.trackable_export(tm, 0.05, out_cap)
    np.testing.assert_array_equal(te[3].numpy(), np.asarray(je[3]))
    ok = te[3].numpy()
    for a, b in zip(te[:3], je[:3]):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok],
                                   rtol=1e-6, atol=1e-6)
    exportable = int(tgm.trackable_mask(tm, 0.05).sum())
    assert int(ok.sum()) == min(exportable, out_cap)


@pytest.mark.parametrize("cap,tcap,drops", [
    (1 << 12, 1 << 11, ("insert_dropped", "export_dropped")),
    (1 << 12, 1 << 13, ("insert_dropped",)),   # the target holds the map
    (1 << 14, 1 << 11, ("export_dropped",)),   # the map holds the run
])
def test_engine_counts_the_rows_capacity_left_out(cap, tcap, drops,
                                                  monkeypatch):
    from gs_icp_slam_torch.slam import fused

    offered, left_out = [], []
    add, export = fused.add_gaussians, fused.trackable_export

    def add_spy(m, *args, **kw):
        offered.append(int(args[6].sum()))       # the valid rows
        return add(m, *args, **kw)

    def export_spy(m, th, out_cap):
        left_out.append(max(int(tgm.trackable_mask(m, th).sum())
                            - out_cap, 0))
        return export(m, th, out_cap)

    monkeypatch.setattr(fused, "add_gaussians", add_spy)
    monkeypatch.setattr(fused, "trackable_export", export_spy)
    eng, *_ = _small_run(7, 8, cap, tcap)
    c = eng.fused.counters
    # the map fills from empty and nothing compacts it
    assert c["insert_dropped"] == sum(offered) - eng.state.gmap.n
    assert c["export_dropped"] == sum(left_out)
    for k in ("insert_dropped", "export_dropped"):
        assert (c[k] > 0) == (k in drops), (k, c[k])
