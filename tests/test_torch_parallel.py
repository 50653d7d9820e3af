"""PyTorch port: multi-device mapping (gs_icp_slam_torch/parallel/ and the
mesh paths of slam/fused.py) and the last leftover modules (the dense
oracle ops/rasterize_ref.py, quat_scale_to_reg_cov, utils/profiling.py),
against the JAX package.

The world-size-2 ranks are gloo ranks on the CPU in spawned processes
(tests/torch_parallel_ranks.py: a file store under tmp_path, every group
joined with a 120 s limit, every process under a time limit); they never
import JAX.  World size 1 runs in the test's own process on a world-1
gloo group, destroyed after.  JAX's mesh engine and its opt_step_batched under a mesh are
never run here: on the CPU they are the suite's costliest tests (over
1,400 s and ~40 GB each, run alone).  So the port is held to JAX where it
is cheap:
  * the batched mapping step at world size 2, dp and fsdp, and the
    standalone fsdp step, against JAX's single-device batched mean-loss
    reference of tests/test_parallel.py:82-97 on the same 64x48 map and
    keyframes, with that test's tolerances (loss rtol 1e-5; params and
    Adam m rtol 2e-4: float32 sums in another order);
  * the mesh engine at world size 1 against the engine without a mesh,
    bit for bit (the same function, the same operations);
  * the collective bytes of tests/test_parallel.py's audits, counted at
    the port's collective calls.
At world size 2 the ranks' replicated state is equal bit for bit; dp and
fsdp agree within chip_smoke.py path H2's tolerances (ATE 10 um, PSNR 0.01
dB, counts exact); a mesh autosave resumes bit for bit.
"""
import datetime
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.models import adam_init as j_adam_init
from gs_icp_slam_tpu.models import adam_step as j_adam_step
from gs_icp_slam_tpu.models import add_gaussians as j_add_gaussians
from gs_icp_slam_tpu.models import empty_map as j_empty_map
from gs_icp_slam_tpu.models import map_lr_tree as j_map_lr_tree
from gs_icp_slam_tpu.models import map_params as j_map_params
from gs_icp_slam_tpu.ops import covariance as j_cov
from gs_icp_slam_tpu.ops import rasterize_ref as j_ref
from gs_icp_slam_tpu.ops.projection import project_gaussians as j_project
from gs_icp_slam_tpu.parallel import sharded as j_sharded
from gs_icp_slam_tpu.slam.fused import make_mapping_primitives as j_prims
from gs_icp_slam_tpu.utils import profiling as j_prof
from gs_icp_slam_tpu.utils.camera import Intrinsics as JIntrinsics
from gs_icp_slam_torch.ops import covariance as t_cov
from gs_icp_slam_torch.ops import rasterize_ref as t_ref
from gs_icp_slam_torch.ops.projection import project_gaussians as t_project
from gs_icp_slam_torch.ops.rasterize import rasterize_tiled
from gs_icp_slam_torch.parallel import sharded as t_sharded
from gs_icp_slam_torch.utils import profiling as t_prof

W = 2  # ranks of the world-size-2 scenarios


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ choose_mode, _map_bytes --

@pytest.mark.parametrize("requested", ["auto", "dp", "fsdp"])
def test_choose_mode_and_map_bytes_equal_jax(requested):
    for log_cap in range(10, 25):
        for sh in range(4):
            cap = 1 << log_cap
            assert t_sharded._map_bytes(cap, sh) == \
                j_sharded._map_bytes(cap, sh)
            assert t_sharded.choose_mode(cap, sh, requested) == \
                j_sharded.choose_mode(cap, sh, requested), (cap, sh)
    assert t_sharded.DP_MAX_BYTES == j_sharded.DP_MAX_BYTES
    assert t_sharded.MAP_AXIS == j_sharded.MAP_AXIS


# -------------------------------------------- the batched mapping steps ---

def _j_tiny_cfg():
    """tests/test_parallel.py _tiny_cfg (the ranks build the same one)."""
    w, h = 64, 48
    intr = JIntrinsics(width=w, height=h, fx=60.0, fy=60.0, cx=(w - 1) / 2,
                       cy=(h - 1) / 2, depth_scale=1000.0, depth_trunc=8.0)
    return j_synthetic_config(intr, capacity=1024, target_capacity=256,
                              visible_capacity=256)


def _j_populated_map(cfg, n_pts=400, seed=0):
    """tests/test_parallel.py _populated_map, from the same numpy seed."""
    rng = np.random.default_rng(seed)
    gmap = j_empty_map(cfg.map.capacity, cfg.map.sh_degree)
    return j_add_gaussians(
        gmap,
        jnp.asarray(np.stack([rng.uniform(-1, 1, n_pts),
                              rng.uniform(-0.7, 0.7, n_pts),
                              rng.uniform(1, 3, n_pts)], -1)
                    .astype(np.float32)),
        jnp.asarray(rng.uniform(size=(n_pts, 3)).astype(np.float32)),
        jnp.asarray(np.tile(np.array([0, 0, 0, 1], np.float32),
                            (n_pts, 1))),
        jnp.asarray(rng.uniform(0.02, 0.08, (n_pts, 3)).astype(np.float32)),
        jnp.asarray(rng.uniform(1, 3, n_pts).astype(np.float32)),
        jnp.ones((n_pts,), bool), jnp.ones((n_pts,), bool))


def _keyframe_batch(cfg, b, seed=1):
    """tests/test_parallel.py _keyframe_batch, as numpy."""
    rng = np.random.default_rng(seed)
    h, w = cfg.intr.height, cfg.intr.width
    w2c_b = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    rgb_b = rng.integers(0, 255, (b, 3, h, w)).astype(np.uint8)
    depth_b = rng.uniform(500, 3000, (b, h, w)).astype(np.float32)
    return w2c_b, rgb_b, depth_b


def _jax_batched_reference(cfg, gmap, batch):
    """tests/test_parallel.py:82-97: the mean loss over the batch on one
    device, one Adam step."""
    prim_1 = j_prims(cfg, None)
    lrs = j_map_lr_tree(cfg.opt)
    params = j_map_params(gmap)
    adam = j_adam_init(params)

    @jax.jit
    def reference(params, adam, live, w2c_b, rgb_b, depth_b):
        def loss_fn(p):
            losses, stats = jax.vmap(
                lambda w, r, d: prim_1.opt_loss(p, live, w, r, d))(
                w2c_b, rgb_b, depth_b)
            return jnp.mean(losses), stats
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, adam = j_adam_step(params, grads, adam, lrs, live,
                                   b1=cfg.opt.adam_b1, b2=cfg.opt.adam_b2,
                                   eps=cfg.opt.adam_eps)
        return params, adam, loss

    p, a, loss = reference(params, adam, gmap.live,
                           *(jnp.asarray(x) for x in batch))
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: np.asarray(v) for k, v in a.m.items()}, float(loss))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world-size-2 run of torch_parallel_ranks.world2 (its directory
    holds the engines' files), and JAX's single-device reference on the
    batched steps' inputs."""
    cfg = _j_tiny_cfg()
    gmap = _j_populated_map(cfg)
    batch = _keyframe_batch(cfg, W)
    map_np = {f: np.asarray(getattr(gmap, f)) for f in gmap._fields}
    d = str(tmp_path_factory.mktemp("w2"))
    started = ranks.start("world2", W, d, dict(map_np=map_np,
                                               batch_np=batch))
    ref = _jax_batched_reference(cfg, gmap, batch)  # while the ranks run
    return ranks.join(started), ref, d


@pytest.fixture(scope="module")
def steps(world2):
    out, ref, _ = world2
    param_bytes = sum(v.nbytes for v in ref[0].values())
    return out, ref, param_bytes, 1024


@pytest.mark.parametrize("mode", ["dp", "fsdp", "standalone"])
def test_batched_step_matches_jax_reference(steps, mode):
    """opt_step_batched (dp, fsdp) and make_parallel_opt_step
    ("standalone") at world size 2 against JAX's single-device batched
    mean-loss step, on every rank."""
    out, (p_ref, m_ref, loss_ref), _, _ = steps
    for r in range(W):
        got = out[r][mode]
        assert np.isfinite(got["loss"]) and got["adam_step"] == 1
        np.testing.assert_allclose(got["loss"], loss_ref, rtol=1e-5,
                                   atol=1e-6)
        for k in p_ref:
            np.testing.assert_allclose(
                got["params"][k].numpy(), p_ref[k], rtol=2e-4, atol=1e-6,
                err_msg=f"rank {r} param {k}")
            np.testing.assert_allclose(
                got["adam_m"][k].numpy(), m_ref[k], rtol=2e-4, atol=1e-7,
                err_msg=f"rank {r} adam.m {k}")
    # the ranks end with the same whole map, bit for bit
    for k in p_ref:
        assert torch.equal(out[0][mode]["params"][k], out[1][mode]["params"][k])


def _bytes(audit, op, arrays_only=False):
    return sum(b for o, n, b in audit
               if o == op and not (arrays_only and n <= 4))


def test_collective_audit_batched_step(steps):
    """tests/test_parallel.py:193-257 at the port's collective calls: dp
    all-reduces exactly the parameter bytes and gathers or scatters
    nothing; fsdp gathers the parameters and live, reduce-scatters one
    shard of the gradients, and all-reduces only scalars."""
    out, _, param_bytes, capacity = steps
    for r in range(W):
        dp = out[r]["dp"]["audit"]
        assert {o for o, _, _ in dp} == {"all_reduce"}, dp
        assert _bytes(dp, "all_reduce", arrays_only=True) == param_bytes
        for mode in ("fsdp", "standalone"):
            fs = out[r][mode]["audit"]
            assert _bytes(fs, "all_gather") == param_bytes + capacity, fs
            assert _bytes(fs, "reduce_scatter") == param_bytes // W, fs
            assert _bytes(fs, "all_reduce", arrays_only=True) == 0, fs


def test_collective_audit_fused_step(steps):
    """tests/test_parallel.py:279-323: three dp fused steps (frame 0 and
    two tracked frames, 2 mapping iterations each) move, in array-sized
    all-reduces, exactly their opt steps' parameter bytes: tracking,
    insertion, the target export and the keyframe bookkeeping add none,
    and nothing is gathered or scattered."""
    out, _, param_bytes, _ = steps
    for r in range(W):
        fa = out[r]["fused_audit"]
        assert fa["opt_steps"] == 6, fa["opt_steps"]
        assert {o for o, _, _ in fa["audit"]} == {"all_reduce"}
        assert _bytes(fa["audit"], "all_reduce", arrays_only=True) == \
            fa["opt_steps"] * param_bytes


def test_place_state_layout(steps):
    """tests/test_parallel.py:264-276: in fsdp the map's parameters, masks
    and Adam moments hold the rank's 1/W of the capacity, the count, the
    target and the keyframe store stay whole; in dp everything is
    whole.  state_shardings says the same."""
    out, _, _, capacity = steps
    for r in range(W):
        for mode in ("dp", "fsdp"):
            lay = out[r]["layout"][mode]
            rows = capacity // W if mode == "fsdp" else capacity
            for path, shape in lay["shapes"].items():
                split = lay["shardings"][path]
                if path.startswith(("gmap.", "adam.m.")):
                    assert shape[0] == rows, (mode, path, shape)
                    assert split == ("map" if mode == "fsdp" else None)
                else:
                    assert split is None, (path, split)
            assert lay["shapes"]["target.points"] == (3, 256)
            assert lay["shapes"]["kf_rgb"] == (256, 3, 48, 64)  # default Kc
            assert lay["shapes"]["poses"] == (4, 4, 4)
            assert lay["n"] == 0
            assert lay["shardings"]["gmap.n"] is None
            assert lay["shardings"]["adam.step"] is None


# --------------------------------------------------------- the engines ---

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """torch_parallel_ranks.world1 in this process, on a world-1 gloo
    group (a file store under tmp_path), the group destroyed after."""
    from gs_icp_slam_torch.parallel import make_mesh

    store = tmp_path_factory.mktemp("w1") / "store"
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=ranks.JOIN_S))
    try:
        return ranks.world1(make_mesh("cpu"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_world1_mesh_engine_equals_the_engine(world1, mode):
    """At 96x72, 10 frames, capacity 2^13 (no buckets on either side) and
    draws that give the same keyframe on every iteration: FusedEngine on
    a world-1 mesh equals FusedEngine without one, bit for bit."""
    a, b = world1["none"], world1[mode]
    np.testing.assert_array_equal(b["poses"], a["poses"])
    np.testing.assert_array_equal(b["psnr"], a["psnr"])
    assert b["counts"] == a["counts"] and b["n"] == a["n"]
    assert b["train_iter"] == a["train_iter"] == 20
    for k in a["gmap"]:
        assert torch.equal(b["gmap"][k], a["gmap"][k]), k
    for k in a["adam_m"]:
        assert torch.equal(b["adam_m"][k], a["adam_m"][k]), k
    assert torch.equal(b["target"], a["target"])


@pytest.fixture(scope="module")
def engines(world2):
    out, _, d = world2
    return [o["engines"] for o in out], d


def test_world2_ranks_agree(engines):
    """At world size 2 every rank ends with the same poses, whole map,
    target, keyframe store and counts, bit for bit, in both modes; the
    fsdp ranks hold half the map each."""
    out, _ = engines
    for mode in ("dp", "fsdp"):
        a, b = out[0][mode], out[1][mode]
        np.testing.assert_array_equal(a["poses"], b["poses"])
        for key in ("gmap",):
            for k in a[key]:
                assert torch.equal(a[key][k], b[key][k]), (mode, k)
        for key in ("target", "kf_w2c", "kf_rgb", "kf_depth"):
            assert torch.equal(a[key], b[key]), (mode, key)
        for key in ("n", "num_gaussians", "kf_total", "kf_stored", "psnr",
                    "vis", "tile"):
            assert a[key] == b[key], (mode, key)
    assert out[0]["fsdp"]["local_rows"] == (1 << 13) // W
    assert out[0]["dp"]["local_rows"] == 1 << 13


def test_world2_dp_and_fsdp_agree(engines):
    """dp and fsdp at world size 2: ATE within 10 um, PSNR within 0.01 dB,
    counts equal, no cap drops; save_ply writes on rank 0 only, and every
    rank returns the rows."""
    out, d = engines
    dp, fs = out[0]["dp"], out[0]["fsdp"]
    assert abs(dp["ate"] - fs["ate"]) <= 1e-5
    assert np.abs(dp["poses"] - fs["poses"]).max() <= 1e-5
    assert abs(dp["psnr"] - fs["psnr"]) <= 0.01
    for key in ("num_gaussians", "kf_total", "kf_stored"):
        assert dp[key] == fs[key], key
    assert dp["vis"] == fs["vis"] == 0 and dp["tile"] == fs["tile"] == 0
    for mode in ("dp", "fsdp"):
        assert out[1][mode]["ply_rows"] == out[0][mode]["ply_rows"] == \
            dp["num_gaussians"]
        assert os.path.exists(os.path.join(d, f"{mode}-0.ply"))
        assert not os.path.exists(os.path.join(d, f"{mode}-1.ply"))


def test_world2_autosave_resumes_bit_for_bit(engines):
    """The fsdp run autosaves every 4 frames (rank 0 writes the gathered
    state); a new mesh engine resumed from the last save (frame 8) ends
    equal to the uninterrupted run, on every rank."""
    out, _ = engines
    for r in range(W):
        res, full = out[r]["resumed"], out[r]["fsdp"]
        np.testing.assert_array_equal(res["poses"], full["poses"])
        assert res["train_iter"] == 20
        for k in full["gmap"]:
            assert torch.equal(res["gmap"][k], full["gmap"][k]), k


def test_mesh_engine_raises_without_a_process_group():
    """FusedEngine(mesh=) never runs as a single device: with no process
    group it raises, as make_mesh does."""
    from gs_icp_slam_torch.parallel import make_mesh
    from gs_icp_slam_torch.parallel.mapping import Mesh
    from gs_icp_slam_torch.slam import FusedEngine

    seq, cfg = ranks.engine_cfg("dp")
    assert not torch.distributed.is_initialized()
    mesh = Mesh(size=1, rank=0, group=None, device=torch.device("cpu"),
                backend="gloo")
    with pytest.raises(RuntimeError, match="process group"):
        FusedEngine(seq, cfg, device="cpu", mesh=mesh)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh("cpu")


def test_init_distributed_picks_nccl_for_a_card(monkeypatch):
    """init_distributed joins a CUDA device over NCCL, and over gloo only
    when the caller asks for the CPU (the process group's own init is
    recorded, not run)."""
    from gs_icp_slam_torch.parallel import launch

    calls = []
    monkeypatch.setattr(launch.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    launch.init_distributed("127.0.0.1:29500", 2, 1)
    launch.init_distributed("127.0.0.1:29500", 2, 1, device="cpu")
    assert [c[0] for c in calls] == ["nccl", "gloo"]
    assert calls[0][1]["init_method"] == "tcp://127.0.0.1:29500"
    assert (calls[0][1]["world_size"], calls[0][1]["rank"]) == (2, 1)


def test_init_distributed_and_global_mesh_on_the_cpu():
    """A real world-1 job on the CPU in this process: init_distributed
    (gloo), global_mesh, one gather; the group destroyed after."""
    from gs_icp_slam_torch.parallel import global_mesh, init_distributed

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu", timeout_s=60)
    try:
        m = global_mesh(device="cpu")
        assert (m.size, m.rank, m.backend) == (1, 0, "gloo"), m
        x = torch.arange(4.0)
        assert torch.equal(m.all_gather(x), x)
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------ dense oracle, covariance, models ---

FX = FY = 60.0
RW, RH = 64, 48
CX, CY = (RW - 1) / 2.0, (RH - 1) / 2.0


def _scene(n=64, seed=0, spread=0.8):
    """tests/test_rasterize.py _scene, as numpy."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = rng.uniform(-spread, spread, n)
    xyz[:, 1] = rng.uniform(-spread * 0.7, spread * 0.7, n)
    xyz[:, 2] = rng.uniform(1.2, 3.0, n)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    scale = rng.uniform(0.02, 0.08, size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    sh = rng.uniform(-0.4, 0.4, size=(n, 1, 3)).astype(np.float32)
    live = np.ones((n,), bool)
    live[::7] = False
    return xyz, quat, scale, opacity, sh, live


def _w2c(ang=0.3):
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = [0.1, -0.05, 0.2]
    return w2c


BG = np.array([0.1, 0.2, 0.3], np.float32)


def _t_dense(xyz, quat, scale, opacity, sh, live, w2c, tile_span=7):
    return t_ref.rasterize_dense(xyz, quat, scale, opacity, sh, 0, w2c, FX,
                                 FY, CX, CY, RW, RH, live, torch.from_numpy(BG),
                                 tile_span=tile_span)


def test_rasterize_dense_matches_jax_values_and_gradients():
    """rasterize_dense against JAX's on a tiny scene (a rotated view, dead
    slots, a background), in colour, depth, radii, is_used, and in the
    gradients of a colour/depth loss with respect to xyz, scale, opacity
    and SH (float32 sums in another order: colour within 1e-5, depth 1e-4
    m, the loss rtol 5e-5, each gradient within 1e-4 of its largest
    magnitude)."""
    scene = _scene(48, seed=2)
    w2c = _w2c()
    target = np.full((3, RH, RW), 0.5, np.float32)

    def j_loss(xyz, scale, opacity, sh):
        out = j_ref.rasterize_dense(
            xyz, jnp.asarray(scene[1]), scale, opacity, sh, 0,
            jnp.asarray(w2c), FX, FY, CX, CY, RW, RH, jnp.asarray(scene[5]),
            jnp.asarray(BG), tile_span=7)
        c, d = out[:2]
        return jnp.mean((c - target) ** 2) + 0.1 * jnp.mean(d), out

    (jl, (jc, jd, jr, ju)), jg = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *(jnp.asarray(scene[i]) for i in (0, 2, 3, 4)))

    t = [torch.from_numpy(x) for x in scene]
    leaves = [t[i].clone().requires_grad_(True) for i in (0, 2, 3, 4)]
    c, d, radii, used = _t_dense(leaves[0], t[1], leaves[1], leaves[2],
                                 leaves[3], t[5], torch.from_numpy(w2c))
    loss = torch.mean((c - torch.from_numpy(target)) ** 2) \
        + 0.1 * torch.mean(d)
    loss.backward()
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), atol=1e-4)
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(used.numpy(), np.asarray(ju))
    assert float(c.detach().max()) > 0.15 and used.any() and not used[0]
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=5e-5)
    for leaf, g, name in zip(leaves, jg, ("xyz", "scale", "opacity", "sh")):
        g = np.asarray(g)
        s = np.abs(g).max()
        assert s > 0, name
        np.testing.assert_allclose(leaf.grad.numpy() / s, g / s, atol=1e-4,
                                   err_msg=name)


def test_composite_pixels_matches_jax():
    """composite_pixels at scattered pixel centres without tile rects:
    colour, depth, final transmittance and contributed equal JAX's."""
    xyz, quat, scale, opacity, sh, live = _scene(40, seed=3)
    w2c = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(4)
    pix = np.stack([rng.uniform(0, RW, 300), rng.uniform(0, RH, 300)],
                   -1).astype(np.float32)
    @jax.jit
    def j_run(xyz, quat, scale, opacity, sh, live, pix):
        js = j_project(xyz, quat, scale, opacity, sh, 0, jnp.asarray(w2c),
                       FX, FY, CX, CY, RW, RH, live)
        order = jnp.argsort(jnp.where(js.visible, js.depth, jnp.inf))
        return order, j_ref.composite_pixels(pix, js, order,
                                             jnp.asarray(BG))

    jorder, jout = j_run(*(jnp.asarray(x) for x in (xyz, quat, scale,
                                                    opacity, sh, live, pix)))
    ts = t_project(*(torch.from_numpy(x) for x in (xyz, quat, scale, opacity,
                                                   sh)), 0,
                   torch.from_numpy(w2c), FX, FY, CX, CY, RW, RH,
                   torch.from_numpy(live))
    torder = torch.argsort(torch.where(ts.visible, ts.depth, torch.inf),
                           stable=True)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    tout = t_ref.composite_pixels(torch.from_numpy(pix), ts, torder,
                                  torch.from_numpy(BG))
    for a, b, tol in zip(tout, jout, (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))


@pytest.mark.parametrize("tile_span,tile_cap,spread", [(7, 128, 0.8),
                                                        (3, 256, 0.9)])
def test_tiled_matches_dense(tile_span, tile_cap, spread):
    """The port's rasterize_tiled against the port's rasterize_dense, as
    tests/test_rasterize.py holds JAX's: colour atol 2e-4 (2e-3 at the
    production span 3 and K 256 on a denser scene), depth 2e-3 (2e-2),
    radii exact, no cap drop."""
    n = 96 if tile_span == 7 else 192
    xyz, quat, scale, opacity, sh, live = (torch.from_numpy(x) for x in
                                           _scene(n, seed=11, spread=spread))
    w2c = torch.from_numpy(_w2c(0.2))
    c_d, d_d, r_d, _ = _t_dense(xyz, quat, scale, opacity, sh, live, w2c,
                                tile_span=tile_span)
    out = rasterize_tiled(xyz, quat, scale, opacity, sh, w2c, live,
                          torch.from_numpy(BG), FX, FY, CX, CY, sh_degree=0,
                          width=RW, height=RH, tile=16, tile_span=tile_span,
                          tile_cap=tile_cap, visible_cap=256)
    assert int(out.stats[1]) == 0 and int(out.stats[2]) == 0
    ctol, dtol = (2e-4, 2e-3) if tile_span == 7 else (2e-3, 2e-2)
    np.testing.assert_allclose(out.color.numpy(), c_d.numpy(), atol=ctol)
    np.testing.assert_allclose(out.depth.numpy(), d_d.numpy(), atol=dtol)
    np.testing.assert_array_equal(out.radii.numpy(), r_d.numpy())


def test_quat_scale_to_reg_cov_matches_jax():
    """quat_scale_to_reg_cov against JAX's, ties in the smallest scale
    included (the first of a tie takes eps), and against the port's
    quat_scale_to_reg_cov6 components: within 5e-6 of entries of unit
    scale (float32 rotation products summed in another order)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(257, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.2, (257, 3)).astype(np.float32)
    s[:20, 1] = s[:20, 0]       # ties
    s[20:30] = 0.05             # all three equal
    got = t_cov.quat_scale_to_reg_cov(torch.from_numpy(q),
                                      torch.from_numpy(s)).numpy()
    want = np.asarray(j_cov.quat_scale_to_reg_cov(jnp.asarray(q),
                                                  jnp.asarray(s)))
    np.testing.assert_allclose(got, want, atol=5e-6)
    c6 = t_cov.quat_scale_to_reg_cov6(torch.from_numpy(q),
                                      torch.from_numpy(s)).numpy()
    iu = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])
    np.testing.assert_allclose(got[:, iu[0], iu[1]].T, c6, atol=1e-6)


def test_profiling_models_match_jax():
    """The roofline models' counts equal JAX's; the H100 row holds the
    peaks chip_smoke.py bounds with; leaf_sum sums a nest of tensors."""
    for args in ((1 << 18, 1 << 16, 836, 32, 384, 11_374_076, 9_000),
                 (4096, 1024, 12, 16, 128, 5_000, 300)):
        a, b = t_prof.raster_forward_model(*args), \
            j_prof.raster_forward_model(*args)
        assert (a.name, a.flops, a.bytes) == (b.name, b.flops, b.bytes)
    for args in ((8280, 1 << 16), (100, 7)):
        a, b = t_prof.gicp_iteration_model(*args), \
            j_prof.gicp_iteration_model(*args)
        assert (a.name, a.flops, a.bytes) == (b.name, b.flops, b.bytes)
    h100 = t_prof.CHIPS["h100"]
    assert (h100.peak_flops_f32, h100.hbm_gbps * 1e9) == (67e12, 3.35e12)
    m = t_prof.StageModel("x", 67e9, 1e6)
    jm = j_prof.StageModel("x", 67e9, 1e6)
    jchip = j_prof.ChipSpec("h", 67e12, 989e12, 3350.0)
    assert m.attainable_ms(h100) == jm.attainable_ms(jchip) == 1.0
    assert m.utilization(2.0, h100) == 0.5
    if not torch.cuda.is_available():
        assert t_prof.detect_chip() == t_prof.CHIPS["cpu"]
    tree = {"a": torch.ones(3), "b": (torch.ones(2, dtype=torch.bool),
                                      [torch.full((2, 2), 0.5)]), "n": 7}
    assert float(t_prof.leaf_sum(tree)) == float(j_prof.leaf_sum(
        {"a": jnp.ones(3), "b": (jnp.ones(2, bool),
                                 [jnp.full((2, 2), 0.5)]), "n": 7}))
