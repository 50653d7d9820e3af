"""The staged SLAM engine (counterpart of gs_icp_slam_tpu/slam/engine.py).

Per frame, as in the JAX engine (engine.py:261-331):
  downsample/unproject ....... utils.pointcloud
  frame 0: first target ...... exact k-NN covariances (kernel K3)
  source covariances ......... exact k-NN (kernel K3)
  G-ICP ...................... Gauss-Newton, 1-NN per iteration (kernel K2)
  overlap + keyframe decision  1-NN (kernel K2), host scalars
  insert Gaussians ........... covariance sharing, tracker -> map
  trackable export -> target . covariance sharing, map -> tracker
  mapping iterations ......... render a stored keyframe (K1-fwd), masked
                               L1 + SSIM + depth loss, backward (K1-bwd),
                               masked Adam, pruning every prune_interval
and `run()` runs `mapping_iters_final` more iterations, then renders every
frame of the finished map for PSNR (kernel K1-fwd).  At training stages
1/2 the mapping iterations render at half/quarter resolution
(fused.make_mapping_primitives); `densify_enabled` is read by nothing, as
in the JAX engine, which never calls densify.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import SLAMConfig
from ..datasets.base import RGBDSequence
from ..eval.ate import ate_rmse
from ..models import (adam_init, add_gaussians, empty_map, map_params,
                      prune_large_and_transparent, trackable_export,
                      with_params)
from ..ops.gicp import (GICPTarget, gicp_align, make_source,
                        source_correspondences, target_from_gaussians,
                        target_from_points)
from ..utils.pointcloud import downsample_pointcloud, make_downsample_filter
from ..utils.quat import quat_multiply, rotmat_to_quat
from ..utils.se3 import invert_se3, transform_points
from .fused import make_mapping_primitives


@dataclass
class SLAMResult:
    poses: np.ndarray            # (N, 4, 4) estimated c2w
    gt_poses: Optional[np.ndarray]
    ate_rmse: Optional[float]    # meters
    fps: float
    num_gaussians: int
    psnr: Optional[float] = None
    per_frame_psnr: Optional[np.ndarray] = None
    kf_total: int = 0            # keyframes ever selected
    kf_stored: int = 0           # keyframe slots in use (< total => evicted)
    # cap-overflow observability: the largest visible-cap and tile-cap
    # drops, read after each frame's mapping iterations as the JAX engine
    # reads them (zero = no cap cost quality); with no mapping iteration
    # in the run, over the evaluation renders instead
    vis_cap_dropped: int = 0
    tile_cap_dropped: int = 0


class SLAMEngine:
    def __init__(self, dataset: RGBDSequence, cfg: SLAMConfig,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.cfg = cfg
        intr = cfg.intr
        self.filt = make_downsample_filter(
            intr.width, intr.height, intr.fx, intr.fy, intr.cx, intr.cy,
            cfg.downsample_rate)
        self.rng = np.random.default_rng(seed)

        self.gmap = empty_map(cfg.map.capacity, cfg.map.sh_degree,
                              self.device)
        self.adam = adam_init(map_params(self.gmap))
        self.prim = make_mapping_primitives(cfg, self.device)
        self.tile_cap = self.prim.raster.keywords["tile_cap"]  # K per tile
        self.target: Optional[GICPTarget] = None

        kf_cap = max(8, cfg.engine.keyframe_capacity)
        self.kf_w2c = np.zeros((kf_cap, 4, 4), np.float32)
        self.kf_rgb = np.zeros((kf_cap, 3, intr.height, intr.width), np.uint8)
        self.kf_depth = np.zeros((kf_cap, intr.height, intr.width),
                                 np.float32)
        self.kf_count = 0
        self.kf_total = 0
        self.new_keyframes: List[int] = []

        self.poses: List[np.ndarray] = []
        self.from_last_kf = 0
        self.train_iter = 0

        self.bg = torch.tensor(cfg.render.bg_color, dtype=torch.float32,
                               device=self.device)
        self._last_stats: Optional[torch.Tensor] = None
        self._vis_dropped = 0
        self._pair_dropped = 0

    # ------------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _preprocess(self, frame):
        intr = self.cfg.intr
        pc = downsample_pointcloud(self.filt, self._to_device(frame.depth),
                                   self._to_device(frame.rgb),
                                   intr.depth_scale, intr.depth_trunc)
        return (pc["points"], pc["colors"], pc["z"], pc["valid"],
                pc["trackable"])

    def _insert(self, pts_w, colors, rots, scales, z, trackable, valid):
        self.gmap = add_gaussians(self.gmap, pts_w, colors, rots, scales, z,
                                  trackable, valid,
                                  init_opacity=self.cfg.map.init_opacity)

    def _export_target(self) -> GICPTarget:
        cap = self.cfg.engine.target_capacity
        pts, rots, scales, valid = trackable_export(
            self.gmap, self.cfg.map.trackable_opacity_th, cap)
        return target_from_gaussians(pts, rots, scales, valid, self.cfg.gicp,
                                     capacity=cap)

    def _store_keyframe(self, frame, w2c: np.ndarray):
        # reservoir eviction once full: the stored set stays a uniform
        # sample of all keyframes ever selected
        kc = self.kf_w2c.shape[0]
        if self.kf_count >= kc:
            i = int(self.rng.integers(kc))
            if i in self.new_keyframes:
                self.new_keyframes.remove(i)
        else:
            i = self.kf_count
            self.kf_count += 1
        self.kf_w2c[i] = w2c
        self.kf_rgb[i] = frame.rgb.transpose(2, 0, 1)
        self.kf_depth[i] = frame.depth
        self.kf_total += 1
        self.new_keyframes.append(i)

    def _mapping_iterations(self, n_iters: int):
        """n_iters opt steps, each on one stored keyframe: the newest
        unseen keyframes first, then uniform picks from self.rng (the
        generator the keyframe eviction draws from, as in JAX)."""
        params = map_params(self.gmap)
        for _ in range(n_iters):
            if self.kf_count == 0:
                return
            if self.new_keyframes:
                i = self.new_keyframes.pop(0)
            else:
                i = int(self.rng.integers(self.kf_count))
            self.train_iter += 1
            if self.train_iter % self.cfg.map.prune_interval == 0:
                self.gmap = prune_large_and_transparent(
                    with_params(self.gmap, params),
                    self.cfg.map.prune_min_opacity, self.cfg.map.prune_extent)
            params, self.adam, _, self._last_stats = self.prim.opt_step(
                params, self.adam, self.gmap.live,
                self._to_device(self.kf_w2c[i]),
                self._to_device(self.kf_rgb[i]),
                self._to_device(self.kf_depth[i]))
        # one device sync per mapping batch, as in the JAX engine
        if self._last_stats is not None:
            s = self._last_stats.tolist()
            self._vis_dropped = max(self._vis_dropped, int(s[1]))
            self._pair_dropped = max(self._pair_dropped, int(s[2]))
        self.gmap = with_params(self.gmap, params)

    # ------------------------------------------------------------------
    def step(self, idx: int, frame) -> None:
        cfg = self.cfg
        points, colors, z, valid, trackable = self._preprocess(frame)

        if idx == 0:
            pose0 = np.asarray(
                frame.gt_c2w if frame.gt_c2w is not None else np.eye(4),
                np.float32)
            self.poses.append(pose0)
            pose0_t = self._to_device(pose0)
            pts_w = transform_points(pose0_t, points)
            self.target, quat, scales = target_from_points(
                pts_w, trackable, cfg.gicp,
                capacity=cfg.engine.target_capacity)
            self._insert(pts_w, colors, quat, scales, z, trackable, valid)
            self._store_keyframe(
                frame, invert_se3(pose0_t).cpu().numpy())
            self.from_last_kf = 0
            self._mapping_iterations(cfg.engine.mapping_iters_per_frame)
            return

        source = make_source(points, valid, cfg.gicp, trackable=trackable,
                             query_grid=(self.filt.gh, self.filt.gw))
        prev = np.asarray(self.poses[-1], np.float64)
        model = cfg.gicp.motion_model
        init_np, init2_np = prev, None
        if (model in ("constant_velocity", "adaptive")
                and len(self.poses) >= 2):
            # extrapolate the last relative motion (see GICPConfig)
            prev2 = np.asarray(self.poses[-2], np.float64)
            cv = prev @ np.linalg.inv(prev2) @ prev
            if model == "adaptive":
                init2_np = cv
            else:
                init_np = cv
        init_T = self._to_device(init_np.astype(np.float32))
        init_T2 = (None if init2_np is None
                   else self._to_device(init2_np.astype(np.float32)))
        T, _, _, _ = gicp_align(source, self.target, init_T, cfg.gicp,
                                init_T2=init_T2)

        pts_w = transform_points(T, source.points)
        _, sqd = source_correspondences(T, source.points, self.target,
                                        source.nn_order)
        n_track = source.valid.sum()
        overlap = (source.valid & (sqd < cfg.kf.overlapped_th)).sum()
        ratio = overlap / torch.clamp(n_track, min=1)
        rots_w = quat_multiply(rotmat_to_quat(T[:3, :3])[None], source.quat)
        self.poses.append(T.cpu().numpy().astype(np.float64))

        last = idx >= len(self.dataset) - 1
        if last or float(ratio) < cfg.kf.keyframe_th:
            tracking_kf, self.from_last_kf = True, 0
        else:
            tracking_kf = False
            self.from_last_kf += 1
        mapping_kf = (not tracking_kf
                      and self.from_last_kf % cfg.kf.keyframe_freq == 0)

        if tracking_kf or mapping_kf:
            if tracking_kf:
                # overlap dedup gates the trackable mask only: all points
                # still become Gaussians (mp_Tracker.py:266-275)
                new_trackable = trackable & (sqd > cfg.kf.overlapped_th2)
            else:
                new_trackable = trackable
            self._insert(pts_w, colors, rots_w, source.scales, z,
                         new_trackable, valid)
            self._store_keyframe(frame, invert_se3(T).cpu().numpy())
            if tracking_kf:
                # covariance sharing, map -> tracker (mp_Tracker.py:286-288)
                self.target = self._export_target()

        self._mapping_iterations(cfg.engine.mapping_iters_per_frame)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def render_eval(self, w2c: torch.Tensor, frame):
        """Render the map from one world-to-camera pose (kernel K1-fwd),
        with the GL-convention principal point ((W-1)/2, (H-1)/2) of the
        reference's renderer.  Returns (colour (3, H, W), PSNR over the
        pixels with depth, raster stats)."""
        intr = self.cfg.intr
        m = self.gmap
        out = self.prim.raster(
            m.xyz, m.rotation, torch.exp(m.log_scaling),
            torch.sigmoid(m.opacity_logit[:, 0]),
            self.prim.sh_concat(map_params(m)), w2c, m.live, self.bg,
            intr.fx, intr.fy, (intr.width - 1) / 2.0,
            (intr.height - 1) / 2.0)
        gt_img = self._to_device(frame.rgb.transpose(2, 0, 1)).float() / 255.0
        gt_depth = self._to_device(frame.depth) / intr.depth_scale
        mask = (gt_depth > 0.0)[None]
        mse = torch.sum(((out.color - gt_img) * mask) ** 2) / torch.clamp(
            mask.sum() * 3.0, min=1.0)
        psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
        return out.color, psnr, out.stats

    def run(self, eval_render: bool = True, eval_stride: int = 1,
            progress: bool = False) -> SLAMResult:
        n = len(self.dataset)
        t0 = time.perf_counter()
        for i in range(n):
            self.step(i, self.dataset[i])
            if progress and i % 50 == 0:
                print(f"frame {i}/{n}  gaussians={self.gmap.num_live}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        fps = n / (time.perf_counter() - t0)
        if self.cfg.engine.mapping_iters_final:
            self._mapping_iterations(self.cfg.engine.mapping_iters_final)

        poses = np.stack(self.poses)
        gt = self.dataset.gt_poses
        ate = None
        if gt.ndim == 3:  # every frame carries a ground-truth pose
            ate = ate_rmse(gt, poses)
        else:
            gt = None

        psnr_mean = None
        per_frame = None
        if eval_render:
            vals = []
            for i in range(0, n, eval_stride):
                w2c = invert_se3(self._to_device(poses[i].astype(np.float32)))
                _, p, stats = self.render_eval(w2c, self.dataset[i])
                vals.append(float(p))
                if self.train_iter == 0:
                    s = stats.tolist()
                    self._vis_dropped = max(self._vis_dropped, int(s[1]))
                    self._pair_dropped = max(self._pair_dropped, int(s[2]))
            per_frame = np.asarray(vals)
            psnr_mean = float(per_frame.mean())

        return SLAMResult(poses=poses, gt_poses=gt, ate_rmse=ate, fps=fps,
                          num_gaussians=self.gmap.num_live,
                          psnr=psnr_mean, per_frame_psnr=per_frame,
                          kf_total=self.kf_total, kf_stored=self.kf_count,
                          vis_cap_dropped=self._vis_dropped,
                          tile_cap_dropped=self._pair_dropped)
