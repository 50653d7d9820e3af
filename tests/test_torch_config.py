"""PyTorch port: configuration parity with the JAX package, the state
converters, and the port's isolation from JAX."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import gs_icp_slam_tpu.config as jcfg
import gs_icp_slam_torch
import gs_icp_slam_torch.config as tcfg
from gs_icp_slam_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTR = dict(width=128, height=96, fx=74.0, fy=74.0, cx=63.5, cy=47.5,
            depth_scale=1000.0, depth_trunc=8.0)


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out.append((f.name, f.default))
        elif f.default_factory is not dataclasses.MISSING:
            out.append((f.name, f.default_factory()))
        else:
            out.append((f.name, None))  # required field
    return out


@pytest.mark.parametrize("name", ["GICPConfig", "OptConfig", "MapConfig",
                                  "KeyframeConfig", "EngineConfig",
                                  "RenderConfig", "SLAMConfig"])
def test_dataclass_fields_and_defaults_equal(name):
    jf = _fields(getattr(jcfg, name))
    tf = _fields(getattr(tcfg, name))
    assert [n for n, _ in jf] == [n for n, _ in tf]
    for (n, a), (_, b) in zip(jf, tf):
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), n
        else:
            assert a == b, n


def test_intrinsics_fields_equal():
    from gs_icp_slam_tpu.utils.camera import Intrinsics as JI
    from gs_icp_slam_torch.utils.camera import Intrinsics as TI
    assert _fields(JI) == _fields(TI)
    j, t = JI(**INTR), TI(**INTR)
    assert (j.fovx, j.fovy, j.tan_fovx, j.tan_fovy) == (
        t.fovx, t.fovy, t.tan_fovx, t.tan_fovy)
    np.testing.assert_array_equal(j.matrix(), t.matrix())


@pytest.mark.parametrize("preset", ["synthetic", "replica", "tum"])
def test_presets_equal_and_convert(preset):
    from gs_icp_slam_tpu.utils.camera import Intrinsics as JI
    from gs_icp_slam_torch.utils.camera import Intrinsics as TI
    if preset == "synthetic":
        j = jcfg.synthetic_config(JI(**INTR), downsample_rate=4,
                                  capacity=1 << 14)
        t = tcfg.synthetic_config(TI(**INTR), downsample_rate=4,
                                  capacity=1 << 14)
    else:
        j = getattr(jcfg, f"{preset}_config")()
        t = getattr(tcfg, f"{preset}_config")()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert convert.config_from_dict(dataclasses.asdict(j)) == t


def test_map_and_target_from_numpy():
    rng = np.random.default_rng(0)
    C = 16
    d = dict(xyz=rng.normal(size=(C, 3)).astype(np.float32),
             f_dc=rng.normal(size=(C, 3)).astype(np.float32),
             f_rest=np.zeros((C, 0, 3), np.float32),
             log_scaling=rng.normal(size=(C, 3)).astype(np.float32),
             rotation=rng.normal(size=(C, 4)).astype(np.float32),
             opacity_logit=rng.normal(size=(C, 1)).astype(np.float32),
             trackable=rng.random(C) > 0.5, live=rng.random(C) > 0.3,
             n=np.int32(12))
    m = convert.map_from_numpy(d, device="cpu")
    assert m.n == 12 and m.capacity == C
    for k, v in d.items():
        if k != "n":
            np.testing.assert_array_equal(getattr(m, k).numpy(), v)
    t = convert.target_from_numpy(dict(
        points=d["xyz"].T, cov6=rng.normal(size=(6, C)).astype(np.float32),
        valid=d["live"], nn_bias=np.where(d["live"], 0.0, 3.4e38)
        .astype(np.float32)[None]), device="cpu")
    assert t.capacity == C and t.valid.dtype == torch.bool


def test_fp32_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        assert gs_icp_slam_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gs_icp_slam_torch.resolve_device()
    assert gs_icp_slam_torch.resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of gs_icp_slam_torch, and chip_smoke.py, import with
    jax and gs_icp_slam_tpu made unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["gs_icp_slam_tpu"] = None
        import gs_icp_slam_torch
        names = [m.name for m in pkgutil.walk_packages(
            gs_icp_slam_torch.__path__, "gs_icp_slam_torch.")]
        for n in names:
            importlib.import_module(n)
        for n in ("bench", "eval.image_metrics", "eval.lpips",
                  "eval.lpips_fixtures", "cli", "__main__", "io.ply",
                  "io.checkpoint", "io.colmap", "datasets.replica",
                  "datasets.tum", "datasets.scene", "eval.offline",
                  "viz.network_gui", "viz.rerun_logger",
                  "parallel.sharded", "parallel.mapping", "parallel.launch",
                  "ops.rasterize_ref", "utils.profiling"):
            assert "gs_icp_slam_torch." + n in names, n
        import chip_smoke
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "gs_icp_slam_tpu")
               and sys.modules[m] is not None]
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 48


def test_no_import_statement_names_jax():
    """No import statement anywhere in the port, chip_smoke.py or the
    port's scripts (scripts/torch_*.py) names jax or the JAX package, even
    one that the import test above would not reach (inside a function)."""
    import ast
    import glob
    files = glob.glob(os.path.join(REPO, "gs_icp_slam_torch", "**", "*.py"),
                      recursive=True)
    files += [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))
    assert len(files) >= 25
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib",
                                               "gs_icp_slam_tpu"), (path, m)
