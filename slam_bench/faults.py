"""Faults planted in the program's timed path, to show that the checks
of slam_bench/check.py catch them (python -m slam_bench.control --fault
<name>, and the harness's tests).  Never imported by a benchmark run.

Each fault is a list of (attribute of gs_icp_slam_torch.slam.fused, its
replacement):

  pose_unchanged     G-ICP returns its seed pose (the step leaves the
                     state unchanged)
  pose_altered       G-ICP's pose moved by 1 mm (the answer altered)
  mapping_unchanged  Adam leaves the map and its own state as they were
  half_image         the mapping loss is the mean over half the image
  mapping_skipped_alternate
                     every other frame's mapping iterations leave the
                     map and Adam's state as they were (run() skipping
                     mapping on half of the frames)
"""
from __future__ import annotations

NAMES = ("pose_unchanged", "pose_altered", "mapping_unchanged",
         "half_image", "mapping_skipped_alternate")


def patches(name: str, iters_per_frame: int = 3) -> list:
    from gs_icp_slam_torch.slam import fused

    if name in ("pose_unchanged", "pose_altered"):
        orig = fused.gicp_align

        def broken(source, target, init_T, cfg, init_T2=None):
            T, n, idx, sqd = orig(source, target, init_T, cfg,
                                  init_T2=init_T2)
            if name == "pose_unchanged":
                return init_T.clone(), n, idx, sqd
            T = T.clone()
            T[0, 3] += 1e-3
            return T, n, idx, sqd

        return [("gicp_align", broken)]
    if name == "mapping_unchanged":
        def frozen(params, grads, state, lrs, update_mask, **kw):
            return params, state

        return [("adam_step", frozen)]
    if name == "half_image":
        orig = fused.mapping_loss

        def half(image, depth, gt_image, gt_depth, **kw):
            h = image.shape[1] // 2
            return orig(image[:, :h], depth[:h], gt_image[:, :h],
                        gt_depth[:h], **kw)

        return [("mapping_loss", half)]
    if name == "mapping_skipped_alternate":
        orig = fused.adam_step
        calls = [0]

        def alternate(params, grads, state, lrs, update_mask, **kw):
            frame = calls[0] // iters_per_frame
            calls[0] += 1
            if frame % 2:
                return params, state
            return orig(params, grads, state, lrs, update_mask, **kw)

        return [("adam_step", alternate)]
    raise ValueError(f"unknown fault {name!r}; known: {NAMES}")


def plant(name: str, iters_per_frame: int = 3):
    """Plant the fault; returns the function that takes it out."""
    from gs_icp_slam_torch.slam import fused

    saved = []
    for attr, fn in patches(name, iters_per_frame):
        saved.append((attr, getattr(fused, attr)))
        setattr(fused, attr, fn)

    def undo():
        for attr, fn in reversed(saved):
            setattr(fused, attr, fn)

    return undo
