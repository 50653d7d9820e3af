"""The traced episode's records: device and host events from the profiler,
the union of device-busy intervals, and the breakdown of device time and
idle gaps.

Events are kept as arrays (names once each, events as name ids and
nanosecond bounds) so that a metric reader, and its unit test on a
recorded fixture, need neither the profiler nor a card:
  dev_*    kernels, memcpys and memsets on the card
  host_*   host ops and CUDA runtime calls
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class Events:
    dev_names: list
    dev_id: np.ndarray
    dev_start: np.ndarray
    dev_end: np.ndarray
    host_names: list
    host_id: np.ndarray
    host_start: np.ndarray
    host_end: np.ndarray
    t0: int          # the traced window, ns on the events' clock
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def n_dev(self) -> int:
        return int(self.dev_id.shape[0])

    @classmethod
    def from_json(cls, d: dict) -> "Events":
        dev = np.array(d["dev"], np.int64).reshape(-1, 3)
        host = np.array(d["host"], np.int64).reshape(-1, 3)
        return cls(d["dev_names"], dev[:, 0], dev[:, 1], dev[:, 2],
                   d["host_names"], host[:, 0], host[:, 1], host[:, 2],
                   int(d["t0"]), int(d["t1"]))


def from_profiler(prof, t0_ns: int, t1_ns: int) -> Events:
    """The events of a stopped torch.profiler.profile and the traced window
    [t0_ns, t1_ns]: time.time_ns() readings taken around the traced
    episode, the profiler's own clock.  Where the device events fall
    outside it (another clock), the window is their own span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ids = ({}, {})
    rows = ([], [])
    for ev in prof.profiler.kineto_results.events():
        side = 0 if ev.device_type() == cuda else 1
        name = ev.name()
        i = ids[side].setdefault(name, len(ids[side]))
        s = ev.start_ns()
        rows[side].append((i, s, s + ev.duration_ns()))
    arr = [np.array(r, np.int64).reshape(-1, 3) for r in rows]
    dev, host = arr
    if dev.shape[0] and (dev[:, 1].min() < t0_ns
                         or dev[:, 2].max() > t1_ns + 10 ** 9):
        t0_ns, t1_ns = int(dev[:, 1].min()), int(dev[:, 2].max())
    return Events(list(ids[0]), dev[:, 0], dev[:, 1], dev[:, 2],
                  list(ids[1]), host[:, 0], host[:, 1], host[:, 2],
                  int(t0_ns), int(t1_ns))


def union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of [start, end) pairs: (starts, ends), sorted."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def _busy_intervals(ev: Events):
    return union(np.clip(ev.dev_start, ev.t0, ev.t1),
                 np.clip(ev.dev_end, ev.t0, ev.t1))


def busy_s(ev: Events) -> float:
    """Seconds of the window in which some operation ran on the device."""
    s, e = _busy_intervals(ev)
    return float((e - s).sum()) * 1e-9


def time_by_name(ev: Events, match) -> float:
    """Device seconds of the operations whose name `match` accepts."""
    hit = np.array([bool(match(n)) for n in ev.dev_names] + [False], bool)
    keep = hit[ev.dev_id]
    return float((ev.dev_end[keep] - ev.dev_start[keep]).sum()) * 1e-9


def kernel_ms_per_frame(rec, names) -> float | None:
    """A metric reader's body: device milliseconds a frame, in the traced
    episode of `rec` (run.Record), of the kernels whose names contain one
    of `names` (demangled or not); None where none ran."""
    if rec.trace is None or not rec.trace_frames:
        return None
    s = time_by_name(rec.trace, lambda n: any(k in n for k in names))
    return s * 1e3 / rec.trace_frames if s > 0 else None


def syncs_per_frame(rec) -> float | None:
    """A metric reader's body: the synchronising CUDA calls that
    torch.cuda.set_sync_debug_mode("warn") reports over whole run()
    calls, over the frames of those calls (the harness's own
    synchronisations are not counted)."""
    if not rec.sync_frames:
        return None
    return rec.sync_count / rec.sync_frames


def short(name: str) -> str:
    """A kernel's or op's name without its argument list."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)", "{anon}")
    return name.split("(")[0][:120] or name[:120]


def _top(names, ids, weights, top):
    tot = np.bincount(ids, weights=weights, minlength=len(names))
    merged: dict = {}
    for n, t in zip(names, tot):
        if t > 0:
            k = short(n)
            merged[k] = merged.get(k, 0.0) + float(t)
    best = sorted(merged.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v * 1e-9] for k, v in best]


def device_ops(ev: Events, top: int = 10):
    """The device operations that took most time: [[name, seconds], ...]."""
    return _top(ev.dev_names, ev.dev_id,
                (ev.dev_end - ev.dev_start).astype(np.float64), top)


def idle_gaps(ev: Events, top: int = 10):
    """Device idle time inside the window, summed by what the host was
    doing in the middle of each gap (the innermost host event that covers
    it, else "host: no op"): [[name, seconds], ...], largest first."""
    s, e = _busy_intervals(ev)
    g0 = np.concatenate([[ev.t0], e])
    g1 = np.concatenate([s, [ev.t1]])
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    if len(g0) == 0:
        return []
    mid = (g0 + g1) // 2
    names = list(ev.host_names) + ["host: no op"]
    who = np.full(len(mid), len(names) - 1, np.int64)
    if len(ev.host_start):
        o = np.argsort(ev.host_start, kind="stable")
        hs, he, hid = ev.host_start[o], ev.host_end[o], ev.host_id[o]
        pos = np.searchsorted(hs, mid, side="right") - 1
        found = np.zeros(len(mid), bool)
        # the latest-starting host event that still covers the midpoint:
        # nested ops start later than their parents
        for back in range(16):
            p = np.clip(pos - back, 0, None)
            hit = (~found) & (pos - back >= 0) & (he[p] >= mid)
            who[hit] = hid[p[hit]]
            found |= hit
    return _top(names, who, (g1 - g0).astype(np.float64), top)


def load(path) -> Events:
    with open(path) as f:
        return Events.from_json(json.load(f))
