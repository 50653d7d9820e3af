"""One run of one benchmark cell of gs_icp_slam_torch on the card:

    python -m slam_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(slam_bench/configs/<name>.json: the SLAMConfig as run, the sensor) and a
traffic mix (slam_bench/traffic/<name>.json: the camera path, the episode
length, closed or open loop and the rate).  Metrics are readers of their
own, slam_bench/metrics/<name>.py, found by the names in BENCHMARK.json.

Set-up (`setup_s`, from the interpreter's start): the kernels built or
found in the checkout's build directory, the cell's frames made on the
card from --seed and copied to the host (a sensor or a loader hands the
engine host arrays), one FusedEngine, and one warm-up episode.

Window: FusedEngine.run(eval_render=False) over whole episodes, each a
fixed-length session from an empty map, until --seconds have passed.  In
a closed loop the frames are handed over as fast as run() takes them; in
an open loop frame i of an episode is not handed over before t_start +
i / rate, and the pose of each frame is stamped through run()'s per-frame
hook (net_gui).  With --trace 1 the window is two episodes: one under
torch.profiler, one with the synchronisation count.

After the window: one line per episode on stdout (ATE, keyframes,
Gaussians, opt steps, cap drops, kernel launches), then the checks that
decide `correct` (slam_bench/check.py: each window episode held to the
cell's limits, slam_bench/cells/<cell>.json, and one more frame step held
to the plain reference), and the result as the last line of stdout.
Nothing is written to disk.
"""
from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

import numpy as np  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gs_icp_slam_tpu")


class Frame(NamedTuple):
    rgb: np.ndarray      # (H, W, 3) uint8
    depth: np.ndarray    # (H, W) float32 raw units
    gt_c2w: np.ndarray   # (4, 4) float64


class Episode:
    """One session's frames as a dataset for FusedEngine: host arrays, and
    in an open loop a sensor clock (frame i is not returned before
    t_start + i / rate)."""

    def __init__(self, rgb, depth, gt, n: int, rate: float | None = None):
        self.rgb, self.depth, self.gt, self.n = rgb, depth, gt, n
        self.rate = rate
        self.t_start = 0.0

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Frame:
        if not 0 <= i < self.n:
            raise IndexError(i)
        if self.rate:
            wait = self.t_start + i / self.rate - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        return Frame(self.rgb[i], self.depth[i], self.gt[i])

    @property
    def gt_poses(self) -> np.ndarray:
        return self.gt[:self.n]

    def start(self) -> None:
        self.t_start = time.perf_counter()

    def due(self, i: int) -> float:
        return self.t_start + i / self.rate


class Draws:
    """The step's random draws (uniform integers in [0, maxval)), made by
    the benchmark from the seed; `log` records them while it is a list."""

    def __init__(self, seed: int):
        self.rng = np.random.Generator(np.random.PCG64(seed))
        self.log = None

    def __call__(self, maxval: int) -> int:
        v = int(self.rng.integers(maxval))
        if self.log is not None:
            self.log.append((int(maxval), v))
        return v

    def position(self):
        return self.rng.bit_generator.state

    def restore(self, pos) -> None:
        self.rng.bit_generator.state = pos


class PoseClock:
    """run()'s per-frame hook (its net_gui argument), serving no viewer:
    each call synchronises the device, so that the frame's pose has been
    computed, and stamps the clock.  `sync` (the synchronisation, kept
    out of the synchronisation count) may be None: then it only stamps."""

    def __init__(self, sync=None):
        self.sync = sync
        self.stamps: list = []

    def poll(self, render_fn) -> None:
        if self.sync is not None:
            self.sync()
        self.stamps.append(time.perf_counter())


class Record:
    """What a run measured; the metric readers take their numbers here."""

    def __init__(self):
        self.setup_s = None
        self.episodes: list = []
        self.trace = None         # trace.Events of the traced episode
        self.trace_frames = 0
        self.sync_count = 0
        self.sync_frames = 0


def load_json(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slam_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic, metrics, and the limits
    its window episodes are held to (slam_bench/cells/<cell>.json)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    held = f"slam_bench/cells/{workload}.json"
    held = load_json(held) if (ROOT / held).exists() else {}
    return {"cell": cell, "config": load_json(cfg_entry["file"]),
            "traffic": load_json(f"slam_bench/traffic/{cell['traffic']}.json"),
            "episode_limits": held.get("limits", {}),
            "episode_expect": held.get("expect", {}),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def slam_config(conf: dict, traffic: dict):
    """The SLAMConfig a configuration file states, with the traffic's
    fps_cap where it sets one (a replay runs unthrottled)."""
    import dataclasses

    from gs_icp_slam_torch.config import (EngineConfig, GICPConfig,
                                          KeyframeConfig, MapConfig,
                                          OptConfig, RenderConfig,
                                          SLAMConfig)
    from gs_icp_slam_torch.utils.camera import Intrinsics

    c = conf["slam_config"]
    render = dict(c["render"], bg_color=tuple(c["render"]["bg_color"]))
    cfg = SLAMConfig(intr=Intrinsics(**c["intr"]),
                     dataset_type=c["dataset_type"],
                     downsample_rate=c["downsample_rate"],
                     gicp=GICPConfig(**c["gicp"]), opt=OptConfig(**c["opt"]),
                     map=MapConfig(**c["map"]), kf=KeyframeConfig(**c["kf"]),
                     engine=EngineConfig(**c["engine"]),
                     render=RenderConfig(**render))
    if "fps_cap" in traffic:
        cfg = cfg.replace(engine=dataclasses.replace(
            cfg.engine, fps_cap=traffic["fps_cap"]))
    return cfg


def make_frames(conf: dict, traffic: dict, seed: int, device):
    """The episode's frames and one more (the frame after its last, for
    the check), made on `device` from the seed, on the host."""
    from slam_bench.scene import Camera, Path as CamPath, Room, render_frames

    c = conf["slam_config"]["intr"]
    cam = Camera(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"],
                 c["depth_scale"])
    room = Room(tuple(conf["assumed"]["room"]["half_extent"]),
                conf["assumed"]["room"]["tex_freq"])
    return render_frames(cam, room, CamPath(**traffic["path"]),
                         traffic["episode_frames"] + 1,
                         noise=conf["sensor"]["depth_noise"],
                         quantize=conf["sensor"]["quantize"], seed=seed,
                         device=device)


def episode_line(res, engine, ep: Episode, cfg) -> dict:
    from slam_bench.ate import ate_rmse

    poses = np.asarray(res.poses, np.float64)
    ok = np.isfinite(poses).all(axis=(1, 2))
    return {"ate_m": (ate_rmse(ep.gt_poses[ok], poses[ok])
                      if ok.sum() >= 3 else None),
            "keyframes": int(res.kf_total),
            "gaussians": int(res.num_gaussians),
            "opt_steps": int(engine.state.adam.step),
            "map_slots_used": int(engine.state.gmap.n),
            "map_capacity": int(cfg.map.capacity),
            "vis_cap_dropped": int(res.vis_cap_dropped),
            "tile_cap_dropped": int(res.tile_cap_dropped),
            "frames_not_finite": int((~ok).sum())}


def sync(device, counted=True) -> None:
    """Wait for the device; uncounted, with the synchronisation count's
    debug mode off for the call."""
    import torch

    if device.type != "cuda":
        return
    if counted:
        torch.cuda.synchronize(device)
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode(mode)


class Bench(NamedTuple):
    """A cell set up for one seed: its settings, frames and engine."""
    spec: dict
    cfg: object
    ep: Episode
    rgb: np.ndarray
    depth: np.ndarray
    draws: Draws
    engine: object
    device: object
    marks: list


def setup(spec: dict, seed: int, device) -> Bench:
    """The kernels built or found, the cell's frames made on `device`
    from the seed and copied to the host, one FusedEngine (no warm-up)."""
    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.slam.fused import FusedEngine

    conf, traffic = spec["config"], spec["traffic"]
    cfg = slam_config(conf, traffic)
    marks = [("start", time.perf_counter())]
    if device.type == "cuda":
        cuda_build.build_all()
    marks.append(("kernels", time.perf_counter()))
    rgb, depth, gt = make_frames(conf, traffic, seed, device)
    marks.append(("frames", time.perf_counter()))
    ep = Episode(rgb, depth, gt, traffic["episode_frames"])
    draws = Draws(seed)
    engine = FusedEngine(ep, cfg, device=device, draws=draws)
    return Bench(spec, cfg, ep, rgb, depth, draws, engine, device, marks)


def run_episode(b: Bench, rate: float | None = None, hook=None,
                syncs: dict | None = None) -> dict:
    """One whole episode through FusedEngine.run(eval_render=False): in
    an open loop (`rate`) from a sensor clock with the pose stamped by a
    PoseClock, else closed loop with `hook` (if any) as run()'s per-frame
    hook.  With `syncs`, the synchronising CUDA calls of run() are added
    to syncs["n"]."""
    import torch

    ep, dev = b.ep, b.device
    ep.rate = rate
    clock = PoseClock(lambda: sync(dev, counted=False)) if rate else hook
    sync(dev)
    ep.start()
    t0 = time.perf_counter()
    if syncs is not None and dev.type == "cuda":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = b.engine.run(eval_render=False, net_gui=clock)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs["n"] += sum("synchroniz" in str(w.message) for w in caught)
    else:
        res = b.engine.run(eval_render=False, net_gui=clock)
    sync(dev)
    t1 = time.perf_counter()
    e = {"frames": ep.n, "seconds": t1 - t0,
         **episode_line(res, b.engine, ep, b.cfg)}
    if rate:
        lat = [(s - ep.due(i)) * 1e3 for i, s in enumerate(clock.stamps)]
        e["latency_ms"] = lat
        e["latency_p50_ms"] = float(np.percentile(lat, 50))
        e["latency_p95_ms"] = float(np.percentile(lat, 95))
        e["latency_last15_less_first15_ms"] = float(
            np.median(lat[-15:]) - np.median(lat[:15]))
    return e


def measure(spec: dict, seed: int, seconds: float, trace: int, device,
            stats=None) -> dict:
    """Set-up, window and check of one cell on `device`; returns the
    result line's fields.  `stats(line)` receives each episode's line."""
    import torch

    from gs_icp_slam_torch import cuda_build
    from slam_bench import check
    from slam_bench import trace as tr

    cuda = device.type == "cuda"
    traffic = spec["traffic"]
    b = setup(spec, seed, device)
    rate = traffic["rate"] if traffic["loop"] == "open" else None
    rec = Record()
    syncs = {"n": 0}

    run_episode(b)                               # warm-up, unthrottled
    sync(device)
    marks = b.marks + [("warm-up", time.perf_counter())]
    rec.setup_s = time.perf_counter() - _T_START
    print("slam_bench: set-up " + ", ".join(
        f"{q[0]} {q[1] - p[1]:.1f} s" for p, q in zip(marks, marks[1:]))
        + f", before them {marks[0][1] - _T_START:.1f} s", file=sys.stderr)
    cuda_build.reset_launch_counts()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        sync(device)
        prof.start()
        t0 = time.time_ns()
        rec.episodes.append(run_episode(b, rate))
        t1 = time.time_ns()
        w = time.perf_counter()
        prof.stop()
        w1 = time.perf_counter()
        rec.trace = tr.from_profiler(prof, t0, t1)
        rec.trace_frames = b.ep.n
        del prof
        print(f"slam_bench: the profiler stopped in {w1 - w:.1f} s, its "
              f"{rec.trace.n_dev} device and {rec.trace.host_id.shape[0]} "
              f"host events were read in {time.perf_counter() - w1:.1f} s",
              file=sys.stderr)
        rec.episodes.append(run_episode(b, rate, syncs=syncs))
        rec.sync_count, rec.sync_frames = syncs["n"], b.ep.n
    else:
        w0 = time.perf_counter()
        while True:
            rec.episodes.append(run_episode(b, rate))
            if time.perf_counter() - w0 >= seconds:
                break
    launches = {k: v.launches for k, v in cuda_build.KERNELS.items()
                if v.launches}
    for i, e in enumerate(rec.episodes):
        info = {k: v for k, v in e.items() if k != "latency_ms"}
        if stats:
            stats({"episode": i, **info,
                   **({"kernel_launches": launches} if i == 0 else {})})
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    t_check = time.perf_counter()
    checks, _ = check.run_check(b, rec.episodes)
    print(f"slam_bench: the check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    def value(mod):
        v = mod.read(rec)
        return None if v is None or not math.isfinite(v) else float(v)

    metrics = {}
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    for m in wanted:
        mod = load_reader(m["name"])
        if mod.UNIT != m["unit"] or mod.MOVES != m.get("moves"):
            raise SystemExit(f"metric {m['name']}: its reader says unit "
                             f"{mod.UNIT!r}, moves {mod.MOVES!r}; "
                             f"BENCHMARK.json says {m['unit']!r}, "
                             f"{m.get('moves')!r}")
        v = value(mod)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct),
           "attempted": sum(e["frames"] for e in rec.episodes),
           "failed": sum(e["frames_not_finite"] for e in rec.episodes),
           "metrics": metrics, "device": dev_info}
    if trace and rec.trace is not None:
        dev_info["busy_s"] = tr.busy_s(rec.trace)
        dev_info["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(rec.trace),
                            "idle_gaps": tr.idle_gaps(rec.trace)}
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = load_json("BENCHMARK.json")
    spec = cell_spec(bench, args.workload)
    chips = spec["cell"]["chips"]
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"slam_bench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees {seen}. No result.", file=sys.stderr)
        return 2
    try:
        import gs_icp_slam_torch  # noqa: F401
    except ImportError as e:
        print(f"slam_bench: the program under test is not importable here "
              f"({e}). No result.", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    out = measure(spec, args.seed, args.seconds, args.trace,
                  torch.device("cuda", 0),
                  stats=lambda line: print(json.dumps(line), flush=True))
    found = forbidden_modules()
    if found:
        print(f"slam_bench: the run loaded {found}, which nothing it runs "
              f"may import. No result.", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
