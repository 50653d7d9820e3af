"""PyTorch port: training stages 1/2 (mapping at half/quarter resolution)
against the JAX package's make_mapping_primitives.

  * `_downsample_gt` on a 97x71 frame at sdiv 2 and 4 (the crop to whole
    blocks): depth (nearest) exact, RGB (area mean) within rtol 1e-6 (the
    same 4 or 16 values summed in another order);
  * `opt_loss` and one `opt_step` at stages 1 and 2 on a 96x72 map of 300
    splats, from a seeded Adam state (moments m, v and step 3, so that an
    update is a smooth function of the gradient; from zero moments Adam
    turns any gradient into a full learning-rate step of its sign): the
    loss within rtol 1e-5, every gradient and every parameter's update
    (new - old) within 1e-4 of its group's largest |gradient| or
    |update| (the rasterizer's and the SSIM blur's sums in another
    order), the cap-drop stats exact.
The renders use 16-pixel tiles and K = 256 per tile (stages 1/2 take K =
max_per_tile), and one unpadded chunk of the JAX XLA compositor, so that
the JAX CPU side stays cheap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_icp_slam_tpu.config import synthetic_config as j_synthetic_config
from gs_icp_slam_tpu.models import adam_init as j_adam_init
from gs_icp_slam_tpu.models import gaussian_map as jgm
from gs_icp_slam_tpu.slam.fused import \
    make_mapping_primitives as j_make_prims
from gs_icp_slam_tpu.utils.camera import Intrinsics
from gs_icp_slam_torch import convert
from gs_icp_slam_torch.models import AdamState
from gs_icp_slam_torch.slam.fused import _downsample_gt
from gs_icp_slam_torch.slam.fused import \
    make_mapping_primitives as t_make_prims

W, H, N = 96, 72, 300


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(stage, width=W, height=H):
    """The JAX config and the port's, at a stage."""
    intr = Intrinsics(width=width, height=height, fx=60.0, fy=60.0,
                      cx=(width - 1) / 2, cy=(height - 1) / 2,
                      depth_scale=1000.0, depth_trunc=8.0)
    cfg = j_synthetic_config(intr, capacity=1024, target_capacity=256,
                             visible_capacity=512)
    sdiv = 2 * stage if stage else 1
    tiles = -(-(width // sdiv) // 16) * -(-(height // sdiv) // 16)
    cfg = cfg.replace(
        opt=dataclasses.replace(cfg.opt, training_stage=stage),
        render=dataclasses.replace(cfg.render, tile_size=16,
                                   max_per_tile=256, composite_chunk=tiles))
    return cfg, convert.config_from_dict(dataclasses.asdict(cfg))


def _jax_downsample(cfg):
    """The JAX package's _downsample_gt (a closure of opt_loss)."""
    loss = j_make_prims(cfg).opt_loss
    cell = loss.__closure__[loss.__code__.co_freevars.index("_downsample_gt")]
    return cell.cell_contents


@pytest.mark.parametrize("sdiv", [2, 4])
def test_downsample_gt_matches_jax(sdiv):
    rng = np.random.default_rng(sdiv)
    img = rng.uniform(size=(3, 71, 97)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (71, 97)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    j_img, j_dep = _jax_downsample(_cfgs(sdiv // 2, 97, 71)[0])(
        jnp.asarray(img), jnp.asarray(depth))
    t_img, t_dep = _downsample_gt(torch.as_tensor(img),
                                  torch.as_tensor(depth), sdiv)
    assert tuple(t_img.shape) == (3, 71 // sdiv, 97 // sdiv)
    np.testing.assert_array_equal(t_dep.numpy(), np.asarray(j_dep))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=1e-6)


def _inputs(cfg):
    """A seeded map of N splats in front of the camera (JAX), its numpy
    copy, a seeded Adam state (step 3) and a keyframe."""
    rng = np.random.default_rng(7)
    m = jgm.empty_map(cfg.map.capacity, cfg.map.sh_degree)
    m = jgm.add_gaussians(
        m,
        jnp.asarray(np.stack([rng.uniform(-1, 1, N),
                              rng.uniform(-0.7, 0.7, N),
                              rng.uniform(1, 3, N)], -1).astype(np.float32)),
        jnp.asarray(rng.uniform(size=(N, 3)).astype(np.float32)),
        jnp.asarray(np.tile(np.array([0, 0, 0, 1], np.float32), (N, 1))),
        jnp.asarray(rng.uniform(0.02, 0.08, (N, 3)).astype(np.float32)),
        jnp.asarray(rng.uniform(1, 3, N).astype(np.float32)),
        jnp.ones((N,), bool), jnp.ones((N,), bool), init_opacity=0.5)
    params = jgm.map_params(m)
    adam = j_adam_init(params)
    adam = adam._replace(
        m={k: jnp.asarray(rng.normal(0, 1e-3, v.shape).astype(np.float32))
           for k, v in adam.m.items()},
        v={k: jnp.asarray(rng.uniform(1e-6, 1e-5, v.shape)
                          .astype(np.float32)) for k, v in adam.v.items()},
        step=jnp.int32(3))
    view = (jnp.eye(4, dtype=jnp.float32),
            jnp.asarray(rng.integers(0, 255, (3, H, W)), jnp.uint8),
            jnp.asarray(rng.uniform(500, 3000, (H, W)).astype(np.float32)))
    return m, params, adam, view


def _group_close(got, want, what):
    for k in want:
        w = np.asarray(want[k])
        if w.size == 0:  # f_rest at SH degree 0
            continue
        scale = float(np.abs(w).max())
        assert scale > 0, (what, k)  # the step moved every group
        err = float(np.abs(got[k].detach().numpy() - w).max())
        assert err <= 1e-4 * scale, (what, k, err, scale)


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_opt_loss_and_step_match_jax(stage):
    jcfg, tcfg = _cfgs(stage)
    m, jparams, jadam, view = _inputs(jcfg)
    jprim = j_make_prims(jcfg)
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jprim.opt_loss(p, m.live, *view), has_aux=True))(jparams)
    jnew, _, jloss2, _ = jax.jit(jprim.opt_step)(jparams, jadam, m.live,
                                                 *view)

    tprim = t_make_prims(tcfg, device="cpu")
    tparams = {k: torch.as_tensor(np.array(v)) for k, v in jparams.items()}
    live = torch.as_tensor(np.array(m.live))
    tview = [torch.as_tensor(np.array(a)) for a in view]
    leaves = {k: p.clone().requires_grad_(True) for k, p in tparams.items()}
    tloss, tstats = tprim.opt_loss(leaves, live, *tview)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_array_equal(tstats.numpy(), np.asarray(jstats))
    assert int(jstats[0]) > 0  # splats were visible at the stage geometry
    _group_close({k: p.grad for k, p in leaves.items()}, jgrads, "grad")

    tadam = AdamState(m={k: torch.as_tensor(np.array(v))
                         for k, v in jadam.m.items()},
                      v={k: torch.as_tensor(np.array(v))
                         for k, v in jadam.v.items()}, step=3)
    tnew, tadam2, tloss2, _ = tprim.opt_step(tparams, tadam, live, *tview)
    assert tadam2.step == 4
    np.testing.assert_allclose(float(tloss2), float(jloss2), rtol=1e-5)
    # the step's update (new - old), not the new value: one step moves xyz
    # by ~1e-5 m against values of up to 3 m
    _group_close({k: tnew[k] - tparams[k] for k in tnew},
                 {k: np.asarray(jnew[k]) - np.asarray(jparams[k])
                  for k in jnew}, "update")
