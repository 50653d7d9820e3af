"""The reference's frame step: one tracking keyframe of the fused SLAM
step, from a given state, in plain PyTorch.

For the frame: the downsampled cloud and its source covariances; G-ICP
from the adaptive seed against the state's target; the frame's points
inserted at the tail of the map (every valid point; the trackable ones
not already within the overlap threshold of the target); the keyframe
stored (a new slot, or a drawn victim once the store is full); the
target exported from the map's live trackable Gaussians above the
opacity threshold; then the mapping iterations, newest keyframe first and
drawn ones after, each one opt step (render, the mapper's loss, its
gradient, masked Adam) with the prune every prune_interval iterations.

The state comes in as plain tensors and numbers (`State`); the settings
as the configuration file's dict.  Nothing of the program is imported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import geometry as G
from . import render as Rn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PARAMS = ("xyz", "f_dc", "f_rest", "log_scaling", "rotation",
          "opacity_logit")


@dataclass
class State:
    """What a frame step reads and writes."""

    params: dict           # PARAMS -> (C, ...) float32
    trackable: torch.Tensor
    live: torch.Tensor
    n: int                 # slots ever allocated
    adam_m: dict
    adam_v: dict
    adam_step: int
    target: dict           # points (3, Tc), cov6 (6, Tc), valid (Tc,)
    prev: torch.Tensor     # the last two poses, c2w (4, 4)
    prev2: torch.Tensor
    kf_count: int
    kf_total: int
    train_iter: int
    keyframes: dict = field(default_factory=dict)  # slot -> (w2c, rgb, depth)


def insert(st: State, pts, colors, quats, scales, z, trackable, ok,
           init_opacity, q):
    """The valid rows appended at the tail in order; rows past capacity
    dropped."""
    C = st.live.shape[0]
    sel = torch.nonzero(ok).squeeze(1)
    room = max(min(int(sel.shape[0]), C - st.n), 0)
    sel = sel[:room]
    dst = slice(st.n, st.n + room)
    p = st.params
    p["xyz"][dst] = pts[sel]
    p["f_dc"][dst] = q((colors[sel] - 0.5) / Rn.C0)
    zz = torch.clamp((z[sel] ** 1.5) * 2.0, min=1.0)
    p["log_scaling"][dst] = q(torch.log(torch.clamp(scales[sel], min=1e-12)
                                        / zz[:, None]))
    p["rotation"][dst] = quats[sel]
    p["opacity_logit"][dst] = math.log(init_opacity / (1.0 - init_opacity))
    if p["f_rest"].shape[1] > 0:
        p["f_rest"][dst] = 0.0
    st.trackable[dst] = trackable[sel]
    st.live[dst] = True
    st.n = min(st.n + int(ok.sum()), C)


def export_target(st: State, opacity_th, plane_eps, capacity, q):
    """The live trackable Gaussians above the opacity threshold, in slot
    order, first in a buffer of `capacity` slots; their covariances from
    rotation and scale, plane-regularised."""
    p = st.params
    op = torch.sigmoid(p["opacity_logit"][:, 0])
    mask = st.live & st.trackable & (op > opacity_th)
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:capacity]
    count = int(mask.sum())
    valid = torch.arange(order.shape[0], device=mask.device) < count
    xyz = p["xyz"][order]
    rot = G.quat_normalize(p["rotation"][order])
    scl = torch.exp(p["log_scaling"][order])
    pts = torch.zeros((3, capacity), dtype=xyz.dtype, device=xyz.device)
    c6 = torch.zeros((6, capacity), dtype=xyz.dtype, device=xyz.device)
    c6[0] = c6[3] = c6[5] = 1.0
    v = torch.zeros(capacity, dtype=torch.bool, device=xyz.device)
    k = order.shape[0]
    pts[:, :k] = xyz.T
    c6[:, :k] = q(G.reg_cov6_from_quat_scale(rot, scl, plane_eps))
    v[:k] = valid
    return {"points": q(pts), "cov6": c6, "valid": v, "mask": mask}


def opt_step(st: State, kf, conf, q):
    """Render keyframe kf = (w2c, rgb (3, H, W) uint8, depth raw), the
    loss, its gradient, masked Adam: updates st; returns the gradient."""
    c = conf["slam_config"]
    intr, rc, o = c["intr"], c["render"], c["opt"]
    w2c, rgb, depth = kf
    p = st.params
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    v_cap = rc["visible_capacity"]
    W, H = intr["width"], intr["height"]
    view = Rn.bin_view(
        leaves["xyz"], leaves["rotation"], torch.exp(leaves["log_scaling"]),
        torch.sigmoid(leaves["opacity_logit"][:, 0]), leaves["f_dc"], w2c,
        st.live, intr["fx"], intr["fy"], (W - 1) / 2.0, (H - 1) / 2.0, W, H,
        rc["tile_size"], rc["tile_span"], v_cap,
        Rn.tile_capacity(W, H, rc["tile_size"], rc["tile_span"], v_cap,
                         rc["max_per_tile"]), q)
    bg = torch.tensor(rc["bg_color"], dtype=torch.float32,
                      device=w2c.device)
    with torch.no_grad():
        color, dimg = view.render(bg, q)
    color = color.detach().requires_grad_(True)
    dimg = dimg.detach().requires_grad_(True)
    gt = rgb.to(torch.float32) / 255.0
    gd = depth / intr["depth_scale"]
    loss = Rn.mapping_loss(color, dimg, gt, gd, o)
    d_color, d_depth = torch.autograd.grad(loss, [color, dimg])
    view.backward(q(d_color), q(d_depth), bg, q)
    grads = {k: (torch.zeros_like(v) if v.grad is None else q(v.grad))
             for k, v in leaves.items()}
    lrs = {"xyz": o["position_lr"] * o["spatial_lr_scale"],
           "f_dc": o["feature_lr"], "f_rest": o["feature_lr"] / 20.0,
           "opacity_logit": o["opacity_lr"],
           "log_scaling": o["scaling_lr"], "rotation": o["rotation_lr"]}
    t = st.adam_step + 1
    one, t32 = np.float32(1.0), np.float32(t)
    bc1 = float(one - np.float32(o["adam_b1"]) ** t32)
    bc2 = float(one - np.float32(o["adam_b2"]) ** t32)
    b1, b2, eps = o["adam_b1"], o["adam_b2"], o["adam_eps"]
    for k in PARAMS:
        g, m, v = grads[k], st.adam_m[k], st.adam_v[k]
        mask = st.live.reshape((-1,) + (1,) * (p[k].dim() - 1))
        m_new = q(b1 * m + (1.0 - b1) * g)
        v_new = q(b2 * v + (1.0 - b2) * (g * g))
        upd = lrs[k] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        p[k] = q(torch.where(mask, p[k] - upd, p[k]))
        st.adam_m[k] = torch.where(mask, m_new, m)
        st.adam_v[k] = torch.where(mask, v_new, v)
    st.adam_step = t
    return {"loss": float(loss.detach()), "stats": view.stats}


def frame_step(st: State, depth, rgb, conf, draws, q=G.ident):
    """One tracking keyframe (the last frame of a run).  depth (H, W) raw,
    rgb (3, H, W) uint8, on the state's device; draws: the recorded
    [maxval, value] pairs the step draws, in order.  Updates st; returns
    the pose and what the comparison reads."""
    c = conf["slam_config"]
    intr, g, kf, m, eng = (c["intr"], c["gicp"], c["kf"], c["map"],
                           c["engine"])
    dev = depth.device
    flat, x_pre, y_pre, gh, gw = G.downsample_filter(
        intr["width"], intr["height"], intr["fx"], intr["fy"], intr["cx"],
        intr["cy"], c["downsample_rate"])
    flat = torch.as_tensor(flat, dtype=torch.long, device=dev)
    z = q(depth.reshape(-1)[flat].to(torch.float32) / intr["depth_scale"])
    colors = rgb.reshape(3, -1)[:, flat].T.to(torch.float32) / 255.0
    pts = q(torch.stack([torch.as_tensor(x_pre, device=dev) * z,
                         torch.as_tensor(y_pre, device=dev) * z, z], -1))
    valid = z != 0.0
    trackable = valid & (z <= intr["depth_trunc"])
    c6, quat, scales = G.source_covariances(pts, valid, gh, gw, g, q)

    prev, prev2 = st.prev, st.prev2
    cv = (prev @ G.invert_se3(prev2)) @ prev
    if g["motion_model"] == "constant_velocity":
        init, init2 = cv, None
    elif g["motion_model"] == "adaptive":
        init, init2 = prev, cv
    else:
        init, init2 = prev, None
    T, iters, sqd = G.gicp_align(pts, c6, trackable, st.target, init, init2,
                                 g, q)
    pts_w = q(G.transform(T, pts))
    rots_w = q(G.quat_multiply(G.rotmat_to_quat(T[:3, :3])[None], quat))

    new_trackable = trackable & (sqd > kf["overlapped_th2"])
    ok = valid
    if kf["insert_dedup_sqd"] > 0.0:
        ok = ok & (sqd > kf["insert_dedup_sqd"])
    n_before = st.n
    insert(st, pts_w, colors, rots_w, scales, z, new_trackable, ok,
           m["init_opacity"], q)
    draws = list(draws)
    kc = eng["keyframe_capacity"]
    victim = draws.pop(0)[1]
    new_kf = st.kf_count if st.kf_count < kc else victim
    st.kf_count = min(st.kf_count + 1, kc)
    st.kf_total += 1
    st.target = export_target(st, m["trackable_opacity_th"], g["plane_eps"],
                              eng["target_capacity"], q)
    st.keyframes[new_kf] = (G.invert_se3(T), rgb, depth)
    m0 = {k: v.clone() for k, v in st.adam_m.items()}
    losses = []
    for it in range(eng["mapping_iters_per_frame"]):
        rand_idx = draws.pop(0)[1]
        idx = new_kf if it == 0 else rand_idx
        st.train_iter += 1
        if st.train_iter % m["prune_interval"] == 0:
            op = torch.sigmoid(st.params["opacity_logit"][:, 0])
            kill = op < m["prune_min_opacity"]
            kill = kill | (torch.exp(st.params["log_scaling"]).max(-1).values
                           > 0.1 * m["prune_extent"])
            st.live = st.live & ~kill
        losses.append(opt_step(st, st.keyframes[idx], conf, q))
    return {"pose": T, "iters": iters, "n_before": n_before, "new_kf": new_kf,
            "adam_m0": m0, "opt": losses}
