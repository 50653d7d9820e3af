"""The checks that decide `correct`.

Each window episode (a whole run() from an empty map):

  opt_steps_off        Adam's step count against the opt steps the
                       configuration states (iterations a frame x frames,
                       plus the final ones): mapping skipped on some
                       frames, or frames dropped, leave it short
  ate_mm, keyframes_off, gaussians_off
                       the episode's ATE, and its keyframe and Gaussian
                       counts off the cell's expected ones, held to the
                       cell's limits (slam_bench/cells/<cell>.json) where
                       that file states them
  map_slots            the most map slots an episode used, against the
                       capacity: an insert that hit it dropped points

Then the program's own state after the window (the final state of the
last episode, its map at the largest size the window reached) takes one
more frame through the program's frame step, FusedStep.step, the step
that run() drives for every frame, with the capacity buckets that run()
would pick for that map: the frame after the episode's last, as a
tracking keyframe.  The plain reference (slam_bench/reference) takes the
same frame from the same state, with the same draws, and each side's
output is compared:

  pose_mm, pose_mdeg   the G-ICP pose (source covariances, K2's 1-NN)
  target_flips         the insert and the target export: the map slots
                       that one side exports and the other not (a new
                       point within rounding of the overlap threshold can
                       flip)
  target_mm, target_cov  the points and covariances of the slots both
                       export
  grad_rel             the mapping: per leaf, the gradients the three opt
                       steps gave Adam (its first moment less the decayed
                       old one), the worst leaf's relative gap (K1-fwd,
                       the loss, K1-bwd)
  param_rel            the Adam updates, worst leaf, over the entries with
                       a gradient
  render_rms           the program's render of its new map against the
                       reference's render of that map (K1-fwd)

The reference reads the program's state to start from and the program's
outputs to judge them, nothing else the program made.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from slam_bench.reference import geometry as G
from slam_bench.reference import render as Rn
from slam_bench.reference.step import PARAMS, State, frame_step

BAD = 1e9   # a number for an output that is missing or of the wrong shape
LEAVES = ("xyz", "f_dc", "log_scaling", "rotation", "opacity_logit")


def _state_from(st, n: int, slots) -> State:
    """The reference's State from the program's SLAMState (clones)."""
    gm = st.gmap
    return State(
        params={k: getattr(gm, k).detach().clone() for k in PARAMS},
        trackable=gm.trackable.clone(), live=gm.live.clone(), n=int(gm.n),
        adam_m={k: v.clone() for k, v in st.adam.m.items()},
        adam_v={k: v.clone() for k, v in st.adam.v.items()},
        adam_step=int(st.adam.step),
        target={"points": st.target.points.clone(),
                "cov6": st.target.cov6.clone(),
                "valid": st.target.valid.clone()},
        prev=st.poses[n - 1].clone(), prev2=st.poses[n - 2].clone(),
        kf_count=int(st.kf_count), kf_total=int(st.kf_total),
        train_iter=int(st.train_iter),
        keyframes={i: (st.kf_w2c[i].clone(), st.kf_rgb[i].clone(),
                       st.kf_depth[i].clone()) for i in slots})


def _copy(s: State) -> State:
    return State(params={k: v.clone() for k, v in s.params.items()},
                 trackable=s.trackable.clone(), live=s.live.clone(), n=s.n,
                 adam_m={k: v.clone() for k, v in s.adam_m.items()},
                 adam_v={k: v.clone() for k, v in s.adam_v.items()},
                 adam_step=s.adam_step, target=dict(s.target), prev=s.prev,
                 prev2=s.prev2, kf_count=s.kf_count, kf_total=s.kf_total,
                 train_iter=s.train_iter, keyframes=dict(s.keyframes))


def program_step(engine, n: int, rgb_n, depth_n, draws, device):
    """The program's frame step on a copy of its final state, the frame
    after the episode's last as a tracking keyframe, with the capacity
    buckets run() picks for the map's size.  Returns (its outputs, the
    reference's starting State, the draws it took, the frame)."""
    from gs_icp_slam_torch.models import map_params
    from gs_icp_slam_torch.slam.state import copy_state

    st = engine.state
    n_bucket, t_bucket = engine._pick_buckets(int(st.gmap.n))
    work = copy_state(st)
    work.poses = torch.cat([work.poses, work.poses[-1:]])  # frame n's row
    depth_t = torch.from_numpy(np.ascontiguousarray(depth_n)).to(device)
    rgb_t = torch.from_numpy(np.ascontiguousarray(
        rgb_n.transpose(2, 0, 1))).to(device)
    pos = draws.position()
    draws.log = []
    work = engine.fused.step(work, depth_t, rgb_t, True, n_bucket, t_bucket)
    log, draws.log = draws.log, None
    draws.restore(pos)
    pose = work.poses[n].detach().clone()
    img, _ = engine.fused.render_eval(map_params(work.gmap), work.gmap.live,
                                      G.invert_se3(pose), rgb_t, depth_t)
    gm = work.gmap
    out = {"pose": pose,
           "target": {"points": work.target.points.clone(),
                      "cov6": work.target.cov6.clone(),
                      "valid": work.target.valid.clone()},
           "params": {k: getattr(gm, k).detach().clone() for k in LEAVES},
           "live": gm.live.clone(), "trackable": gm.trackable.clone(),
           "n": int(gm.n), "adam_m": dict(work.adam.m),
           "render": img.detach().clone()}
    slots = sorted({v for _, v in log[1:] if v < st.kf_count})
    before = _state_from(st, n, slots)
    return out, before, log, (depth_t, rgb_t)


class _tf32:
    """TF32 matrix products and convolutions inside the block (the
    control's precision on the card: the configuration states float32
    with TF32 off)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        b = torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        b = torch.backends
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = self.saved


def reference_step(before: State, frame, conf, log, q=G.ident,
                   tf32=False) -> dict:
    """The reference's frame step from a copy of `before`."""
    s = _copy(before)
    depth_t, rgb_t = frame
    with _tf32(tf32):
        r = frame_step(s, depth_t, rgb_t, conf, log, q)
    return {"pose": r["pose"], "target": s.target, "n": s.n,
            "trackable": s.trackable,
            "params": {k: s.params[k] for k in LEAVES}, "live": s.live,
            "adam_m": s.adam_m, "adam_m0": r["adam_m0"], "opt": r["opt"]}


def _angle_mdeg(R1, R2) -> float:
    """The angle of R1^T R2 in millidegrees, from atan2 of its sine and
    cosine parts (acos of the trace alone loses small angles)."""
    D = R1.double().T @ R2.double()
    s = 0.5 * float(torch.linalg.norm(torch.stack(
        [D[2, 1] - D[1, 2], D[0, 2] - D[2, 0], D[1, 0] - D[0, 1]])))
    c = 0.5 * (float(torch.trace(D)) - 1.0)
    return math.degrees(math.atan2(s, c)) * 1e3


def _rel(a, b) -> float:
    nb = float(torch.linalg.norm(b.double()))
    return float(torch.linalg.norm((a - b).double())) / max(nb, 1e-300)


def _target_gaps(cand, ref, before: State, conf) -> dict:
    """The exported targets slot by slot.  The export takes the live
    trackable Gaussians above the opacity threshold in slot order, after
    the insert and before the mapping; a side's mask follows from the
    state before the step, its own insert count and its trackable bits
    (which nothing after the insert changes)."""
    m = conf["slam_config"]["map"]
    th = m["trackable_opacity_th"]
    if cand["n"] != ref["n"]:
        return {"target_flips": BAD, "target_mm": BAD, "target_cov": BAD}
    live = before.live.clone()
    live[before.n:ref["n"]] = True
    op = torch.sigmoid(before.params["opacity_logit"][:, 0]).clone()
    op[before.n:ref["n"]] = m["init_opacity"]
    mask_c = live & cand["trackable"] & (op > th)
    mask_r = ref["target"]["mask"]
    cap = ref["target"]["valid"].shape[0]
    n_c = int(cand["target"]["valid"].sum())
    if n_c != min(int(mask_c.sum()), cap):
        return {"target_flips": BAD, "target_mm": BAD, "target_cov": BAD}
    both = mask_c & mask_r
    i_c = (torch.cumsum(mask_c.long(), 0) - 1)[both]
    i_r = (torch.cumsum(mask_r.long(), 0) - 1)[both]
    keep = (i_c < cap) & (i_r < cap)
    i_c, i_r = i_c[keep], i_r[keep]
    out = {"target_flips": float((mask_c != mask_r).sum())}
    if i_c.numel() == 0:
        return dict(out, target_mm=0.0, target_cov=0.0)
    dp = cand["target"]["points"][:, i_c] - ref["target"]["points"][:, i_r]
    dc = cand["target"]["cov6"][:, i_c] - ref["target"]["cov6"][:, i_r]
    return dict(out, target_mm=float(dp.abs().max()) * 1e3,
                target_cov=float(dc.abs().max()))


def compare(cand: dict, ref: dict, before: State, conf) -> dict:
    """The numbers, each a gap between a candidate's outputs (the
    program's, or the control's) and the reference's."""
    out = {}
    dt = (cand["pose"][:3, 3] - ref["pose"][:3, 3]).double()
    out["pose_mm"] = float(torch.linalg.norm(dt)) * 1e3
    out["pose_mdeg"] = _angle_mdeg(cand["pose"][:3, :3], ref["pose"][:3, :3])
    out.update(_target_gaps(cand, ref, before, conf))
    b1 = conf["slam_config"]["opt"]["adam_b1"]
    k = len(ref["opt"])
    live = ref["live"]
    grad_gap, param_gap, norms = {}, {}, {}
    for leaf in LEAVES:
        m0 = ref["adam_m0"][leaf][live]
        gsum_r = ref["adam_m"][leaf][live] - (b1 ** k) * m0
        gsum_c = cand["adam_m"][leaf][live] - (b1 ** k) * m0
        norms[leaf] = float(torch.linalg.norm(gsum_r.double()))
        grad_gap[leaf] = _rel(gsum_c, gsum_r)
        # entries with no gradient, or one at rounding level, are left
        # out: Adam's eps of 1e-15 turns those into whole steps of either
        # sign
        a = gsum_r.abs()
        nz = a[a > 0]
        moved = a >= (1e-3 * nz.median() if nz.numel() else 1.0)
        d_r = (ref["params"][leaf] - before.params[leaf])[live][moved]
        d_c = (cand["params"][leaf] - before.params[leaf])[live][moved]
        param_gap[leaf] = _rel(d_c, d_r) if d_r.numel() else 0.0
    # leaves the reference gives no gradient to rounding are left out
    med = float(np.median(list(norms.values())))
    kept = [lf for lf in LEAVES if norms[lf] >= 1e-3 * med]
    out["grad_rel"] = max(grad_gap[lf] for lf in kept)
    out["param_rel"] = max(param_gap[lf] for lf in kept)
    return out


def _render(params, live, w2c, conf, q=G.ident, tf32=False):
    """The reference's render of a map at w2c: (3, H, W)."""
    c = conf["slam_config"]
    intr, rc = c["intr"], c["render"]
    W, H = intr["width"], intr["height"]
    v_cap = rc["visible_capacity"]
    with torch.no_grad(), _tf32(tf32):
        view = Rn.bin_view(
            params["xyz"], params["rotation"],
            torch.exp(params["log_scaling"]),
            torch.sigmoid(params["opacity_logit"][:, 0]), params["f_dc"],
            w2c, live, intr["fx"], intr["fy"], (W - 1) / 2.0, (H - 1) / 2.0,
            W, H, rc["tile_size"], rc["tile_span"], v_cap,
            Rn.tile_capacity(W, H, rc["tile_size"], rc["tile_span"], v_cap,
                             rc["max_per_tile"]), q)
        bg = torch.tensor(rc["bg_color"], dtype=torch.float32,
                          device=w2c.device)
        return view.render(bg, q)[0]


def _rms(a, b) -> float:
    return float(torch.sqrt(torch.mean((a - b).double() ** 2)))


def episode_checks(b, episodes) -> dict:
    """{name: {"value", "limit"}} over the window's episodes."""
    eng = b.cfg.engine
    lim = b.spec.get("episode_limits", {})
    exp = b.spec.get("episode_expect", {})
    out = {"opt_steps_off": {
        "value": max(abs(eng.mapping_iters_per_frame * e["frames"]
                         + eng.mapping_iters_final - e["opt_steps"])
                     for e in episodes), "limit": 0}}
    if "ate_mm" in lim:
        out["ate_mm"] = {"value": max(
            BAD if e["ate_m"] is None else e["ate_m"] * 1e3
            for e in episodes), "limit": lim["ate_mm"]}
    for k in ("keyframes", "gaussians"):
        if k + "_off" in lim:
            out[k + "_off"] = {"value": max(abs(e[k] - exp[k])
                                            for e in episodes),
                               "limit": lim[k + "_off"]}
    out["map_slots"] = {"value": max(e["map_slots_used"] for e in episodes),
                        "limit": b.cfg.map.capacity - 1}
    return out


def run_check(b, episodes, control: str | None = None):
    """({name: {"value", "limit"}}, the control's numbers or None) for a
    set-up cell `b` (run.Bench) after its window `episodes`.  The control
    is the reference in a lower precision put in the program's place:
    "tf32" (TF32 products and convolutions, the nearest below the
    configuration's float32 with TF32 off; on the card) or "bf16" (each
    stage rounded to bfloat16; the CPU rehearsal's, where TF32 does not
    exist)."""
    conf, ep = b.spec["config"], b.ep
    limits = conf.get("limits", {})
    checks = episode_checks(b, episodes)
    n = ep.n
    prog, before, log, frame = program_step(b.engine, n, b.rgb[n],
                                            b.depth[n], b.draws, b.device)
    b.engine.state = None  # the program's state is freed: the reference runs
    ref = reference_step(before, frame, conf, log)
    nums = compare(prog, ref, before, conf)
    w2c = G.invert_se3(prog["pose"])
    nums["render_rms"] = _rms(prog["render"],
                              _render(prog["params"], prog["live"], w2c,
                                      conf))
    checks.update({k: {"value": v, "limit": limits.get(k, BAD)}
                   for k, v in nums.items()})
    ctl = None
    if control:
        kw = {"tf32": True} if control == "tf32" else {"q": G.bf16}
        ctl = compare(reference_step(before, frame, conf, log, **kw),
                      ref, before, conf)
        ctl["render_rms"] = _rms(
            _render(prog["params"], prog["live"], w2c, conf, **kw),
            _render(prog["params"], prog["live"], w2c, conf))
    return checks, ctl
