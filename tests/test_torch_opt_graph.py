"""PyTorch port: the mapping iterations' opt step as a CUDA graph
(slam/fused.py OptGraph) against direct calls of the eager
MappingPrimitives.opt_step.

On a card without a mesh the fused step captures one graph per capacity
bucket on the bucket's first opt step and replays it for every later one;
on the CPU every opt step runs eagerly.  The card test runs a small
synthetic run, then steps copies of its final state through `refine`
(REFINE_CHUNK opt steps, a prune every PRUNE iterations) at two buckets
and the first one again, each against a loop of direct opt_step calls on
the same slice with the same draws.  It needs a CUDA device and skips
without one; the file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_opt_graph.py

Tolerance: none.  The graph runs the eager step's kernels on the same
inputs, and multiplies by the float32 reciprocals of Adam's bias
corrections, which is what the card does for a division by a host
scalar, so parameters, Adam moments, the live mask and the cap-drop
stats come out bit for bit (an H100: equal bits over 64 steps at both
buckets); the training iteration and Adam's step are equal, and the
original state is left bit for bit.
"""
import dataclasses
from dataclasses import fields

import pytest
import torch

from gs_icp_slam_torch.config import synthetic_config
from gs_icp_slam_torch.datasets import open_dataset
from gs_icp_slam_torch.models import (AdamState, GaussianMap, map_params,
                                      prune_large_and_transparent,
                                      with_params)
from gs_icp_slam_torch.slam import (FusedEngine, TorchDraws, copy_state,
                                    make_mapping_primitives)
from gs_icp_slam_torch.slam.fused import REFINE_CHUNK

W, H, ITERS = 128, 96, 3
PRUNE = 5  # prune_interval: refine's 64 opt steps prune 12-13 times


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(device, frames: int) -> FusedEngine:
    """A small synthetic run: map capacity 2^14, a prune every PRUNE
    iterations that drops the splats grown past 5.5 cm (0.1 x the extent:
    none in the run, some in a refine), no final refinement."""
    seq = open_dataset("synthetic", width=W, height=H, num_frames=frames)
    cfg = synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 14,
                           target_capacity=1 << 12,
                           visible_capacity=1 << 11)
    cfg = cfg.replace(
        engine=dataclasses.replace(cfg.engine, mapping_iters_per_frame=ITERS,
                                   mapping_iters_final=0,
                                   keyframe_capacity=16, fps_cap=None),
        map=dataclasses.replace(cfg.map, prune_interval=PRUNE,
                                prune_extent=0.55),
        render=dataclasses.replace(cfg.render, tile_size=16,
                                   max_per_tile=256))
    return FusedEngine(seq, cfg, device=device, draws=TorchDraws(0))


def _tensors(x):
    """Every tensor of a state, in a fixed order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if dataclasses.is_dataclass(x):
        return [t for f in fields(x) for t in _tensors(getattr(x, f.name))]
    return []


def _eager_refine(eng: FusedEngine, state, nb: int) -> dict:
    """refine's REFINE_CHUNK mapping iterations on the state's first nb
    slots as a loop of direct MappingPrimitives.opt_step calls, drawing
    from the engine's draw source as the fused step does."""
    cfg = eng.cfg
    prim = make_mapping_primitives(cfg, eng.device, n_cap=nb)
    gm = GaussianMap(**{f: (state.gmap.n if f == "n"
                            else getattr(state.gmap, f)[:nb].clone())
                        for f in GaussianMap._fields})
    adam = AdamState(m={k: v[:nb].clone() for k, v in state.adam.m.items()},
                     v={k: v[:nb].clone() for k, v in state.adam.v.items()},
                     step=state.adam.step)
    vis, pair = state.stat_vis_dropped, state.stat_pair_dropped
    train_iter = state.train_iter
    for it in range(REFINE_CHUNK):
        r = eng.draws(max(state.kf_count, 1))
        idx = state.new_kf if it == 0 and state.new_kf >= 0 else r
        train_iter += 1
        if train_iter % cfg.map.prune_interval == 0:
            gm = prune_large_and_transparent(gm, cfg.map.prune_min_opacity,
                                             cfg.map.prune_extent)
        params, adam, _, stats = prim.opt_step(
            map_params(gm), adam, gm.live, state.kf_w2c[idx],
            state.kf_rgb[idx], state.kf_depth[idx])
        gm = with_params(gm, params)
        vis = torch.maximum(vis, stats[1])
        pair = torch.maximum(pair, stats[2])
    return dict(gmap=gm, adam=adam, vis=vis, pair=pair, train_iter=train_iter)


def _same(got: torch.Tensor, want: torch.Tensor, name: str) -> None:
    assert torch.equal(got, want), (
        name, float((got - want).abs().max()), float(want.abs().max()))


@pytest.mark.gpu
def test_graphed_opt_step_matches_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the opt step is graphed only on "
                    "a card")
    eng = _engine(torch.device("cuda"), frames=4)
    eng.run(eval_render=False)
    st, c = eng.state, eng.fused.counters
    # the run, at full capacity (MIN_BUCKET is the capacity): one
    # capture, and its first step eager
    assert c["captures"] == c["eager_opt_steps"] == 1
    assert c["replays"] + c["eager_opt_steps"] == st.adam.step == 4 * ITERS
    snap = copy_state(st)
    nb1 = eng._pow2(st.gmap.n)
    assert 2 * nb1 < eng.cfg.map.capacity
    for nb, new in ((nb1, True), (2 * nb1, True), (nb1, False)):
        before = dict(c)
        pos = eng.draws.position()
        got = eng.fused.refine(copy_state(st), nb)
        eng.draws.restore(pos)
        want = _eager_refine(eng, st, nb)
        assert c["captures"] - before["captures"] == int(new)
        assert c["eager_opt_steps"] - before["eager_opt_steps"] == int(new)
        assert c["replays"] - before["replays"] == REFINE_CHUNK - int(new)
        # the prune bit, and the steps moved the map
        assert int(got.gmap.live.sum()) < int(st.gmap.live.sum())
        assert not torch.equal(got.gmap.xyz[:nb], st.gmap.xyz[:nb])
        assert torch.equal(got.gmap.live[:nb], want["gmap"].live)
        for k, p in map_params(want["gmap"]).items():
            _same(getattr(got.gmap, k)[:nb], p, k)
            _same(got.adam.m[k][:nb], want["adam"].m[k], f"m.{k}")
            _same(got.adam.v[k][:nb], want["adam"].v[k], f"v.{k}")
            # slots past the bucket are not the step's
            assert torch.equal(getattr(got.gmap, k)[nb:],
                               getattr(st.gmap, k)[nb:])
        assert got.adam.step == want["adam"].step == st.adam.step + REFINE_CHUNK
        assert got.train_iter == want["train_iter"]
        assert torch.equal(got.stat_vis_dropped, want["vis"])
        assert torch.equal(got.stat_pair_dropped, want["pair"])
    # stepping copies left the original alone, bit for bit
    for a, b in zip(_tensors(st), _tensors(snap), strict=True):
        assert torch.equal(a, b)


def test_cpu_opt_step_stays_eager():
    """On CPU tensors no graph is captured or replayed: every opt step of
    the frames (in the bucket) runs eagerly."""
    eng = _engine("cpu", frames=3)
    eng.MIN_BUCKET = 1024  # the bucket engages for the whole run
    eng.run(eval_render=False)
    assert eng.state.adam.step == 3 * ITERS
    assert eng.fused.counters == {"captures": 0, "replays": 0,
                                  "eager_opt_steps": eng.state.adam.step,
                                  "insert_dropped": 0, "export_dropped": 0}
