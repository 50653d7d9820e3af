"""PyTorch port: the live viewers (gs_icp_slam_torch/viz) — the SIBR
remote-viewer bridge against tests/test_network_gui.py's loopback client,
make_map_render_fn against the JAX package's on the same map, and
FusedEngine.run with a viewer and with the network viewer.

Tolerances, and why: the wire protocol, the view conventions and the
served bytes exact; a map render within one uint8 level of JAX's (the
same float32 image rounded after the compositors' sums run in another
order); a run with a viewer equal to the run without one bit for bit (the
viewer only reads the state).
"""
import dataclasses
import socket
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.viz import network_gui as jgui
from gs_icp_slam_torch.config import synthetic_config
from gs_icp_slam_torch.datasets import open_dataset
from gs_icp_slam_torch.slam import FusedEngine, TorchDraws
from gs_icp_slam_torch.viz import network_gui as tgui
from gs_icp_slam_torch.viz import NetworkGUI, RerunLogger
from test_network_gui import _recv_exact, _request, _send_msg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(gui, render_fn, tries=100):
    for _ in range(tries):
        if gui.poll(render_fn, timeout=0.05):
            return True
    return False


def test_loopback_render_roundtrip():
    """tests/test_network_gui.py's round trip against the port's server:
    the image bytes, the verify string, fx from fov_x, and w2c = (the
    sign-flipped view matrix)^T."""
    captured = {}

    def render_fn(w2c, w, h, fx, fy):
        captured.update(w2c=w2c, w=w, h=h, fx=fx, fy=fy)
        img = np.zeros((h, w, 3), np.uint8)
        img[:, :, 0] = 7
        img[::2, :, 2] = 3
        return img

    gui = NetworkGUI(port=0, verify="vtest")
    try:
        cli = socket.create_connection(("127.0.0.1", gui.port), timeout=5)
        w, h = 100, 60
        view = np.eye(4, dtype=np.float32)
        view[3, :3] = [1.0, 2.0, 3.0]
        _send_msg(cli, _request(w, h, view=view))
        assert _serve(gui, render_fn)
        img = np.frombuffer(_recv_exact(cli, w * h * 3),
                            np.uint8).reshape(h, w, 3)
        vlen = int.from_bytes(_recv_exact(cli, 4), "little")
        assert _recv_exact(cli, vlen) == b"vtest"
        assert (img[:, :, 0] == 7).all() and (img[::2, :, 2] == 3).all()
        assert (img[1::2, :, 2] == 0).all()
        assert captured["w"] == w and captured["h"] == h
        assert abs(captured["fx"] - w / (2 * np.tan(0.6))) < 1e-6
        assert abs(captured["fy"] - h / (2 * np.tan(0.5))) < 1e-6
        m = view.copy()
        m[:, 1] *= -1
        m[:, 2] *= -1
        np.testing.assert_array_equal(captured["w2c"], m.T)
        cli.close()
    finally:
        gui.close()


def test_keepalive_malformed_and_failing_render():
    """A zero-resolution request is a keep-alive (no render, the verify
    string only); a malformed request drops the connection without
    raising; a render function that fails raises out of poll."""
    gui = NetworkGUI(port=0, verify="x")
    try:
        cli = socket.create_connection(("127.0.0.1", gui.port), timeout=5)
        _send_msg(cli, _request(0, 0))
        assert _serve(gui, lambda *a: pytest.fail("must not render"))
        vlen = int.from_bytes(_recv_exact(cli, 4), "little")
        assert _recv_exact(cli, vlen) == b"x"
        _send_msg(cli, {"resolution_x": 8})  # no resolution_y
        assert not gui.poll(lambda *a: pytest.fail("must not render"),
                            timeout=1.0)
        assert gui.conn is None
        cli.close()

        cli = socket.create_connection(("127.0.0.1", gui.port), timeout=5)
        _send_msg(cli, _request(8, 6))

        def broken(*a):
            raise RuntimeError("render failed")

        with pytest.raises(RuntimeError, match="render failed"):
            _serve(gui, broken)
        cli.close()
    finally:
        gui.close()


def _random_map(n=400, seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                    rng.uniform(2.0, 4.0, n)], 1).astype(np.float32)
    params = dict(
        xyz=xyz,
        f_dc=rng.normal(0, 0.8, (n, 3)).astype(np.float32),
        f_rest=np.zeros((n, 0, 3), np.float32),
        log_scaling=np.log(rng.uniform(0.03, 0.12, (n, 3))).astype(
            np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity_logit=rng.normal(0.5, 1.0, (n, 1)).astype(np.float32))
    live = rng.random(n) > 0.1
    return params, live


@pytest.mark.parametrize("size", [(70, 50), (130, 64)])
def test_map_render_fn_matches_jax(size):
    """make_map_render_fn on the same map and view: the port's crop of its
    64-rounded canvas (32-pixel tiles, span 2, K 256) within one uint8
    level of JAX's."""
    params, live = _random_map()
    w, h = size
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.05, 0.2]
    fx = fy = 0.9 * w
    t_fn = tgui.make_map_render_fn(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(live), 0, bg=(0.1, 0.2, 0.3))
    j_fn = jgui.make_map_render_fn(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(live),
        0, bg=(0.1, 0.2, 0.3))
    a, b = t_fn(view, w, h, fx, fy), j_fn(view, w, h, fx, fy)
    assert a.shape == (h, w, 3) and a.dtype == np.uint8
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1
    assert a.std() > 5  # the map covers the view


class FakeViewer:
    def __init__(self):
        self.frames, self.points, self.renders = [], [], []

    def log_frame(self, i, c2w, rgb, depth):
        self.frames.append((i, np.array(c2w), rgb.shape, depth.shape))

    def log_points(self, i, points):
        self.points.append((i, points.shape))

    def log_render(self, i, image_chw):
        self.renders.append((i, image_chw.shape))


def _engine(frames=6, seed=1):
    seq = open_dataset("synthetic", width=64, height=48, num_frames=frames)
    cfg = synthetic_config(seq.intr, downsample_rate=4, capacity=1 << 13,
                           target_capacity=1 << 11, visible_capacity=1 << 10)
    cfg = cfg.replace(engine=dataclasses.replace(
        cfg.engine, mapping_iters_per_frame=1, mapping_iters_final=0,
        frames_per_dispatch=3, fps_cap=None))
    return FusedEngine(seq, cfg, device="cpu", draws=TorchDraws(seed))


def test_run_with_viewer():
    """run(viewer=): one log_frame a frame with that frame's pose, and
    log_points + log_render on every new keyframe (frame 0's included);
    the poses and the map equal a run without the viewer (which steps in
    chunks of 3)."""
    plain = _engine()
    ref = plain.run(eval_render=False)
    eng = _engine()
    viewer = FakeViewer()
    res = eng.run(eval_render=False, viewer=viewer)
    np.testing.assert_array_equal(res.poses, ref.poses)
    assert torch.equal(eng.state.gmap.xyz, plain.state.gmap.xyz)
    assert [f[0] for f in viewer.frames] == list(range(6))
    for i, c2w, rgb_shape, depth_shape in viewer.frames:
        np.testing.assert_array_equal(c2w, res.poses[i].astype(np.float32))
        assert rgb_shape == (48, 64, 3) and depth_shape == (48, 64)
    assert len(viewer.points) == len(viewer.renders) == res.kf_total >= 2
    assert viewer.points[0][0] == viewer.renders[0][0] == 0
    assert all(s[1] == 3 for _, s in viewer.points)
    assert all(s == (3, 48, 64) for _, s in viewer.renders)


def test_run_with_network_viewer(monkeypatch):
    """run(net_gui=): a loopback client's request is served during the run
    (one poll a frame) with the map of the frame that served it: the bytes
    equal make_map_render_fn on a copy of that map, and the run's poses
    equal a run without the viewer."""
    made = []
    orig = tgui.make_map_render_fn

    def recording(params, live, sh_degree, bg=None):
        snap = ({k: v.clone() for k, v in params.items()}, live.clone())
        fn = orig(params, live, sh_degree, bg)

        def render(*a):
            made.append((snap, sh_degree, bg, a))
            return fn(*a)

        return render

    monkeypatch.setattr(tgui, "make_map_render_fn", recording)
    w, h = 70, 50
    gui = NetworkGUI(port=0, verify="seq")
    got = {}

    def client():
        with socket.create_connection(("127.0.0.1", gui.port),
                                      timeout=30) as c:
            _send_msg(c, _request(w, h, fovx=1.2, fovy=1.0))
            got["img"] = _recv_exact(c, w * h * 3)
            got["verify"] = _recv_exact(
                c, int.from_bytes(_recv_exact(c, 4), "little"))

    th = threading.Thread(target=client)
    th.start()
    try:
        res = _engine().run(eval_render=False, net_gui=gui)
    finally:
        th.join(timeout=30)
        gui.close()
    assert not th.is_alive()
    assert got["verify"] == b"seq" and len(made) == 1
    (params, live), sh_degree, bg, args = made[0]
    want = orig(params, live, sh_degree, bg)(*args)
    assert np.frombuffer(got["img"], np.uint8).tobytes() == want.tobytes()
    np.testing.assert_array_equal(res.poses, _engine().run(
        eval_render=False).poses)


def test_rerun_logger_needs_rerun(monkeypatch):
    monkeypatch.setitem(sys.modules, "rerun", None)
    with pytest.raises(ImportError, match="rerun-sdk is not installed"):
        RerunLogger(None)
