"""PyTorch port: PLY export and checkpoints (gs_icp_slam_torch/io) against
the JAX package's io, and FusedEngine's autosave and resume.

Tolerances, and why: PLY files byte-equal (the same header, the same
channel-major SH columns, little-endian float32); checkpoints field by
field exact (a checkpoint copies arrays); a port run resumed from its own
autosave equal to the uninterrupted run bit for bit on the CPU (the same
state and the same draw position give the same arithmetic); a port run
resumed from a JAX checkpoint within 1e-4 m of the JAX run's poses, with
equal counts (the two packages' float32 drift, as in
tests/test_torch_fused.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.datasets import open_dataset as j_open_dataset
from gs_icp_slam_tpu.io import checkpoint as jck
from gs_icp_slam_tpu.io import ply as jply
from gs_icp_slam_tpu.slam import FusedEngine as JFused
from gs_icp_slam_tpu.slam import SLAMEngine as JEngine
from gs_icp_slam_tpu.slam.state import init_state as j_init_state
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.config import synthetic_config
from gs_icp_slam_torch.datasets import open_dataset
from gs_icp_slam_torch.io import checkpoint as tck
from gs_icp_slam_torch.io import ply as tply
from gs_icp_slam_torch.slam import FusedEngine, SLAMEngine, TorchDraws


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """JAX's draw sequence from a key: one split and one randint per draw,
    as the JAX fused step takes them; its position is the key's bytes."""

    def __init__(self, key):
        self.key = jnp.asarray(key)

    def __call__(self, maxval: int) -> int:
        self.key, sub = jax.random.split(self.key)
        return int(jax.random.randint(sub, (), 0, jnp.int32(maxval)))

    def position(self) -> torch.Tensor:
        return torch.from_numpy(np.asarray(self.key).view(np.uint8).copy())

    def restore(self, pos) -> None:
        self.key = jnp.asarray(pos.numpy().view(np.uint32))


# ---------------------------------------------------------------- PLY ----

def _params(n=17, n_rest=3, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        f_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        f_rest=rng.normal(size=(n, n_rest, 3)).astype(np.float32),
        opacity_logit=rng.normal(size=(n, 1)).astype(np.float32),
        log_scaling=rng.normal(size=(n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
    )


_KEYS = ("xyz", "f_dc", "f_rest", "opacity_logit", "log_scaling", "rotation")


@pytest.mark.parametrize("case", ["mask", "sh0", "sh3"])
def test_ply_bytes_equal_jax(case, tmp_path):
    """The port's writer, fed tensors, writes the JAX writer's bytes; each
    package's reader reads the other's file to equal arrays."""
    n_rest = {"mask": 3, "sh0": 0, "sh3": 15}[case]
    p = _params(n=23, n_rest=n_rest, seed=len(case))
    mask = None
    if case == "mask":
        mask = np.random.default_rng(1).random(23) > 0.4
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t" / "t.ply")
    nj = jply.save_ply(jpath, *(p[k] for k in _KEYS), mask=mask)
    nt = tply.save_ply(tpath, *(torch.from_numpy(p[k]) for k in _KEYS),
                       mask=None if mask is None else torch.from_numpy(mask))
    assert nj == nt == (int(mask.sum()) if mask is not None else 23)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    a, b = tply.load_ply(jpath), jply.load_ply(tpath)
    for k in _KEYS:
        want = p[k] if mask is None else p[k][mask]
        np.testing.assert_array_equal(a[k], want, err_msg=k)
        np.testing.assert_array_equal(b[k], want, err_msg=k)
        assert isinstance(a[k], np.ndarray)


# ------------------------------------------------- the fused state ----

def _jax_state(seed=0):
    """The JAX init_state of a small run with every field filled from a
    seed (as numpy: `jax.device_get` of the state)."""
    seq = j_open_dataset("synthetic", width=32, height=24, num_frames=5)
    cfg = j_synthetic_config(seq.intr, downsample_rate=4, capacity=256,
                             target_capacity=128, visible_capacity=128)
    cfg = cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                 keyframe_capacity=4))
    s = jax.device_get(j_init_state(cfg, 5, np.eye(4, dtype=np.float32),
                                    seed=seed))
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return rng.random(a.shape) > 0.5
        if a.dtype == np.uint8:
            return rng.integers(0, 256, a.shape).astype(np.uint8)
        if a.dtype == np.uint32:
            return a
        if np.issubdtype(a.dtype, np.integer):
            return np.asarray(rng.integers(1, 100), a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)

    def fill_tree(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(fill_tree(v) for v in x))
        return fill(x)

    return s._replace(**{f: fill_tree(getattr(s, f)) for f in s._fields})


def _assert_states_equal(a, b):
    """Two port SLAMStates, field by field (the target's JAX fields)."""
    for f in a.gmap._fields:
        x, y = getattr(a.gmap, f), getattr(b.gmap, f)
        if f == "n":
            assert x == y and isinstance(x, int)
        else:
            assert x.dtype == y.dtype
            assert torch.equal(x, y), f
    for k in a.adam.m:
        assert torch.equal(a.adam.m[k], b.adam.m[k])
        assert torch.equal(a.adam.v[k], b.adam.v[k])
    assert a.adam.step == b.adam.step and isinstance(a.adam.step, int)
    for f in ("points", "cov6", "valid", "nn_bias"):
        assert torch.equal(getattr(a.target, f), getattr(b.target, f)), f
    for f in ("poses", "kf_w2c", "kf_rgb", "kf_depth", "stat_vis_dropped",
              "stat_pair_dropped"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("frame_idx", "kf_count", "kf_total", "new_kf", "from_last_kf",
              "train_iter"):
        x, y = getattr(a, f), getattr(b, f)
        assert x == y and type(x) is int and type(y) is int, f
    assert float(a.last_ratio) == float(b.last_ratio)


def test_jax_fused_state_loads_as_convert(tmp_path):
    """A JAX state written by JAX's save_fused_state loads in the port
    equal to convert.state_from_numpy of the same state; the loaded
    target carries K2's order of its points."""
    s = _jax_state()
    path = str(tmp_path / "j.npz")
    jck.save_fused_state(s, path)
    got = tck.load_fused_state(path, device="cpu")
    _assert_states_equal(got, convert.state_from_numpy(s, device="cpu"))
    order = got.target.nn_order
    assert sorted(order.tolist()) == list(range(got.target.capacity))


def test_port_writer_has_jax_keys_shapes_dtypes(tmp_path):
    """The port's writer gives the JAX writer's keys, shapes and dtypes for
    every key but s.rng, plus the draw position under its own keys; it
    reads its own file back field for field, and the draws' position with
    it.  JAX's loader refuses the port's file (no s.rng: one-way)."""
    s = _jax_state(seed=3)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_fused_state(s, jpath)
    state = convert.state_from_numpy(s, device="cpu")
    draws = TorchDraws(7)
    draws(5), draws(9)
    tck.save_fused_state(state, tpath, draws)
    zj, zt = np.load(jpath), np.load(tpath)
    assert set(zt.files) == (set(zj.files) - {"s.rng"}) | {"draws.state"}
    for k in zj.files:
        if k != "s.rng":
            assert zt[k].shape == zj[k].shape, k
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    again = TorchDraws(0)
    _assert_states_equal(tck.load_fused_state(tpath, "cpu", again), state)
    assert [again(11) for _ in range(4)] == [draws(11) for _ in range(4)]
    with pytest.raises(KeyError):
        jck.load_fused_state(tpath)


def test_missing_field_gets_zero_default(tmp_path):
    """A field missing from the file (written before the field existed)
    loads as 0, as in the JAX loader; a RecordedDraws position (count and
    continuation) round-trips."""
    from gs_icp_slam_torch.slam import RecordedDraws

    s = _jax_state(seed=5)
    path = str(tmp_path / "j.npz")
    jck.save_fused_state(s, path)
    z = dict(np.load(path))
    del z["s.stat_pair_dropped"], z["s.from_last_kf"]
    np.savez(path, **z)
    got = tck.load_fused_state(path, device="cpu")
    assert got.from_last_kf == 0 and int(got.stat_pair_dropped) == 0
    assert got.kf_total == int(s.kf_total)

    rec = RecordedDraws([[4, 1], [4, 2], [4, 3]], then=TorchDraws(2))
    [rec(4) for _ in range(5)]
    tck.save_fused_state(got, path, rec)
    rec2 = RecordedDraws([[4, 1], [4, 2], [4, 3]], then=TorchDraws(2))
    tck.load_fused_state(path, "cpu", rec2)
    assert rec2.used == 5 and [rec2(6) for _ in range(3)] == [
        rec(6) for _ in range(3)]


# ---------------------------------------------- the staged engine ----

def _staged_cfg(seq):
    cfg = synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 13,
                           target_capacity=1 << 11, visible_capacity=1 << 11)
    return cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=1))


def test_staged_checkpoint_resume(tmp_path):
    """tests/test_io.py's staged round trip at 96x72, the port alone:
    after 3 frames, save; a new engine loads it; 3 more frames on both
    give equal poses.  The key set, shapes and dtypes of the file equal
    those of JAX's writer on a fresh JAX engine (no target yet), and of
    the port's writer on a fresh port engine."""
    seq = open_dataset("synthetic", width=96, height=72, num_frames=6)
    cfg = _staged_cfg(seq)
    jseq = j_open_dataset("synthetic", width=96, height=72, num_frames=6)
    jcfg = j_synthetic_config(jseq.intr, downsample_rate=4,
                              capacity=1 << 13, target_capacity=1 << 11,
                              visible_capacity=1 << 11)
    jpath, fresh = str(tmp_path / "j.npz"), str(tmp_path / "fresh.npz")
    jck.save_checkpoint(JEngine(jseq, jcfg), jpath)
    tck.save_checkpoint(SLAMEngine(seq, cfg, device="cpu"), fresh)
    zj, zf = np.load(jpath), np.load(fresh)
    assert set(zf.files) == set(zj.files)
    for k in zj.files:
        assert (zf[k].shape, zf[k].dtype) == (zj[k].shape, zj[k].dtype), k
    np.testing.assert_array_equal(zf["rng.state"], zj["rng.state"])

    eng = SLAMEngine(seq, cfg, device="cpu")
    for i in range(3):
        eng.step(i, seq[i])
    path = str(tmp_path / "ckpt.npz")
    tck.save_checkpoint(eng, path)
    z = np.load(path)
    assert {"target.points", "target.nn_bias"} <= set(z.files)
    eng2 = SLAMEngine(seq, cfg, device="cpu")
    tck.load_checkpoint(eng2, path)
    assert eng2.gmap.n == eng.gmap.n and eng2.kf_count == eng.kf_count
    assert eng2.train_iter == eng.train_iter == 3
    assert eng2.new_keyframes == eng.new_keyframes
    np.testing.assert_array_equal(np.stack(eng2.poses), np.stack(eng.poses))
    for f in ("xyz", "f_dc", "opacity_logit", "live"):
        assert torch.equal(getattr(eng2.gmap, f), getattr(eng.gmap, f))
    assert torch.equal(eng2.target.nn_order, eng.target.nn_order)
    assert (eng2.rng.bit_generator.state == eng.rng.bit_generator.state)
    for i in range(3, 6):
        eng.step(i, seq[i])
        eng2.step(i, seq[i])
    np.testing.assert_allclose(np.stack(eng.poses), np.stack(eng2.poses),
                               atol=1e-5)


# ------------------------------------------ FusedEngine autosave ----

def _fused_cfg(cfg_fn, seq):
    cfg = cfg_fn(seq.intr, downsample_rate=4, capacity=1 << 13,
                 target_capacity=1 << 11, visible_capacity=1 << 10)
    # 16-pixel tiles, K <= 256 and 12-tile chunks of the JAX XLA
    # compositor keep the JAX CPU run cheap (as tests/test_torch_fused.py)
    return cfg.replace(
        engine=dataclasses.replace(
            cfg.engine, mapping_iters_per_frame=1, mapping_iters_final=0,
            keyframe_capacity=8),
        render=dataclasses.replace(cfg.render, tile_size=16,
                                   composite_chunk=12, max_per_tile=256))


class Dies(Exception):
    pass


def _engine(seq, cfg, min_bucket=None):
    eng = FusedEngine(seq, cfg, device="cpu")
    if min_bucket is not None:
        eng.MIN_BUCKET = min_bucket
    return eng


def _autosave_then_die(monkeypatch, seq, cfg, path, min_bucket=None):
    """A port run autosaving every 4 frames that "crashes" right after
    the first save (the engine imports save_fused_state lazily, so
    patching the module attribute is enough); returns the buckets it
    saved."""
    orig = tck.save_fused_state
    saved = {}

    def save_then_die(state, p, draws=None, buckets=None):
        orig(state, p, draws, buckets)
        saved.update(frame_idx=state.frame_idx, buckets=buckets)
        raise Dies

    monkeypatch.setattr(tck, "save_fused_state", save_then_die)
    with pytest.raises(Dies):
        _engine(seq, cfg, min_bucket).run(eval_render=False,
                                          checkpoint_every=4,
                                          checkpoint_path=path)
    monkeypatch.setattr(tck, "save_fused_state", orig)
    assert saved["frame_idx"] == 4
    return saved["buckets"]


def test_fused_resume_is_bit_equal(tmp_path, monkeypatch):
    """At 64x48, 8 frames: a run autosaving every 4 frames that dies after
    the save, resumed from the file by a new engine, ends equal to the
    uninterrupted run bit for bit.  Resumed from the same file with the
    draw position removed, the new engine's draws start afresh and the
    map ends another: the position matters."""
    seq = open_dataset("synthetic", width=64, height=48, num_frames=8)
    cfg = _fused_cfg(synthetic_config, seq)
    full_eng = FusedEngine(seq, cfg, device="cpu")
    full = full_eng.run(eval_render=False)
    ck = str(tmp_path / "auto.npz")
    assert _autosave_then_die(monkeypatch, seq, cfg, ck) == (None, None)

    eng = _engine(seq, cfg)
    res = eng.run(eval_render=False, resume_from=ck)
    np.testing.assert_array_equal(res.poses, full.poses)
    assert (res.num_gaussians, res.kf_total, res.kf_stored) == (
        full.num_gaussians, full.kf_total, full.kf_stored)
    a, b = eng.state, full_eng.state
    assert a.train_iter == b.train_iter == 8
    for f in ("xyz", "f_dc", "opacity_logit", "log_scaling", "live"):
        assert torch.equal(getattr(a.gmap, f), getattr(b.gmap, f)), f
    assert torch.equal(eng.draws.position(), full_eng.draws.position())

    z = {k: v for k, v in np.load(ck).items() if not k.startswith("draws")}
    stale = str(tmp_path / "no_draws.npz")
    np.savez(stale, **z)
    eng2 = FusedEngine(seq, cfg, device="cpu")
    eng2.run(eval_render=False, resume_from=stale)
    assert not torch.equal(eng2.state.gmap.f_dc, b.gmap.f_dc)
    with pytest.raises(ValueError, match="sequence length"):
        FusedEngine(seq.slice(0, 6), cfg, device="cpu").run(
            eval_render=False, resume_from=ck)


def test_fused_resume_keeps_the_buckets(tmp_path, monkeypatch):
    """With the minimum map bucket lowered to 256 slots, the map outgrows
    the bucket picked at frame 0 before the autosave at frame 4 (the
    mapping iterations of frames 1-7 see its first slots only).  The
    resumed run takes the saved buckets and ends equal to the
    uninterrupted run bit for bit; resumed from the same file without
    them, it re-picks the buckets from the map's size at frame 4, as the
    JAX engine does, and its map ends another."""
    seq = open_dataset("synthetic", width=64, height=48, num_frames=8)
    cfg = _fused_cfg(synthetic_config, seq)
    full_eng = _engine(seq, cfg, 256)
    full = full_eng.run(eval_render=False)
    ck = str(tmp_path / "auto.npz")
    buckets = _autosave_then_die(monkeypatch, seq, cfg, ck, 256)
    assert tck.saved_buckets(ck) == buckets
    eng = _engine(seq, cfg, 256)
    state_4 = tck.load_fused_state(ck, "cpu")
    assert buckets != eng._pick_buckets(state_4.gmap.n)
    res = eng.run(eval_render=False, resume_from=ck)
    np.testing.assert_array_equal(res.poses, full.poses)
    for f in ("xyz", "f_dc", "opacity_logit", "log_scaling"):
        assert torch.equal(getattr(eng.state.gmap, f),
                           getattr(full_eng.state.gmap, f)), f

    z = {k: v for k, v in np.load(ck).items() if not k.startswith("engine")}
    repick = str(tmp_path / "no_buckets.npz")
    np.savez(repick, **z)
    assert tck.saved_buckets(repick) is None
    eng2 = _engine(seq, cfg, 256)
    eng2.run(eval_render=False, resume_from=repick)
    assert not torch.equal(eng2.state.gmap.f_dc, full_eng.state.gmap.f_dc)


def test_fused_resume_from_jax_checkpoint(tmp_path):
    """A JAX FusedEngine run autosaving at frame 4 (and running on to its
    end); the port resumes from the JAX file with a replay of its s.rng
    and ends within 1e-4 m of the JAX run's poses, counts equal."""
    jseq = j_open_dataset("synthetic", width=64, height=48, num_frames=8)
    jcfg = _fused_cfg(j_synthetic_config, jseq)
    ck = str(tmp_path / "jax.npz")
    jres = JFused(jseq, jcfg).run(eval_render=False, checkpoint_every=4,
                                  checkpoint_path=ck)
    z = np.load(ck)
    assert int(z["s.frame_idx"]) == 4 and "draws.state" not in z.files
    seq = open_dataset("synthetic", width=64, height=48, num_frames=8)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    draws = JaxDraws(z["s.rng"])
    eng = FusedEngine(seq, tcfg, device="cpu", draws=draws)
    eng.load_checkpoint(ck)
    assert eng.state.frame_idx == 4
    res = FusedEngine(seq, tcfg, device="cpu", draws=draws).run(
        eval_render=False, resume_from=ck)
    np.testing.assert_allclose(res.poses, jres.poses, atol=1e-4)
    assert (res.num_gaussians, res.kf_total, res.kf_stored) == (
        jres.num_gaussians, jres.kf_total, jres.kf_stored)


def test_fused_save_ply_and_checkpoint_methods(tmp_path):
    """FusedEngine.save_ply writes the live rows (the PLY the JAX writer
    would write for the same map) and save_checkpoint / load_checkpoint
    round-trip the state and the draws' position."""
    seq = open_dataset("synthetic", width=64, height=48, num_frames=3)
    cfg = _fused_cfg(synthetic_config, seq)
    eng = FusedEngine(seq, cfg, device="cpu", draws=TorchDraws(4))
    eng.run(eval_render=False)
    m = eng.state.gmap
    n = eng.save_ply(str(tmp_path / "scene.ply"))
    assert n == m.num_live > 0
    jply.save_ply(str(tmp_path / "j.ply"), m.xyz.numpy(), m.f_dc.numpy(),
                  m.f_rest.numpy(), m.opacity_logit.numpy(),
                  m.log_scaling.numpy(), m.rotation.numpy(),
                  mask=m.live.numpy())
    assert (open(tmp_path / "scene.ply", "rb").read()
            == open(tmp_path / "j.ply", "rb").read())
    eng.save_checkpoint(str(tmp_path / "c.npz"))
    other = FusedEngine(seq, cfg, device="cpu", draws=TorchDraws(9))
    other.load_checkpoint(str(tmp_path / "c.npz"))
    _assert_states_equal(other.state, eng.state)
    assert torch.equal(other.draws.position(), eng.draws.position())
