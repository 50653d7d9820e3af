"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from gs_icp_slam_torch/csrc (one nvcc per
   source, all at once) and prints the build time;
2. drives the port's paths through their user entry points on the 36-frame
   synthetic sequence at 1200x680, downsample 10, map capacity 2^18,
   target 2^16, visible cap 2^16, keyframe store 64:
     A. the staged SLAMEngine, no mapping iterations: G-ICP tracking,
        covariance-shared map building, target export, render/eval;
     B. the staged SLAMEngine with bench.py's mapping settings: 2 mapping
        iterations per frame (render a keyframe, SSIM/L1/depth loss, the
        compositor's backward, masked Adam), init opacity 0.5, feature lr
        1e-2;
     C. FusedEngine.run on bench.py's scenario (the same settings, grid
        k-NN source covariances, capacity buckets, the reservoir keyframe
        store), replaying the JAX engine's recorded random draws; then one
        refine call (64 mapping iterations);
     D. the dense compositors' entry points, make_composite (K4a) at the
        rasterizer ablation's geometry (scripts/profile_raster.py: 3,225
        tiles of 16x16, K 256) and make_composite_dyn (K4b) at the kernel
        smoke's (scripts/tpu_kernel_smoke.py: 48 tiles, K 128) and at 3,225
        tiles, forward and backward through autograd.
   Every kernel's launch count is zeroed just before each path and read
   just after it; each kernel of the path must be > 0, K1-bwd must run once
   per opt step of paths B and C, and 64 times in the refine call.  ATE,
   Gaussian count, keyframe count and mean PSNR are held against the JAX
   package's values for the same runs (scripts/port_reference.py on the
   CPU); path C also prints its host syncs per frame (torch's CUDA sync
   debug mode, counted inside the fused step);
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K4a/K4b: inputs as scripts/tpu_kernel_smoke.py
   makes them, plus zero-opacity and empty tiles, and K4_view, path B's
   frame-18 view binned at 16-pixel tiles and packed into dense blocks of
   256; forward bit-equal, also against a numpy front-to-back oracle on a
   few tiles, with the pairs it evaluated and culled; backward equal bits
   on two launches, with the (warp, rank) pairs it walked and culled),
   and times kernel,
   plain version and, where one exists, a single PyTorch library call
   computing the same function (CUDA events), beside the least time the
   card could take (bound).  K2 runs twice: on a random cube, and on the
   arguments path C's last Gauss-Newton step handed it (the tracking
   target after the last tracking keyframe, the last frame's source moved
   by its pose), with the share of reference chunks its search culled;
   K3 runs on the first frame's cloud (k = 20 and k = 4) and on a random
   cube of as many points, 30% invalid, with the chunk visits and pairs
   its search counted and bounds on two bases (the row's: the pairs a
   one-chunk-at-a-time search compares; beside it, every pair), and at
   k = 40 (two passes); K2 and K3 also on 1,179,648 references (above
   2^20: chunks sorted a segment at a time); K1-fwd
   must give its plain version's bits, with the pairs it evaluated and
   culled (counted by the kernel, adding up to the pairs the plain
   version examines) and bounds on two bases (the row's: the pairs that
   blend or stop; beside it, every examined pair; the backwards': the
   pairs that blended; beside it, every walked pair); K2, K3, K1-fwd and
   the K4 forwards are exact; K1-bwd and the K4 backwards must give equal
   bits on two launches;
4. then, after path C's run (before its refine), FusedEngine.evaluate
   (per-frame PSNR, SSIM and LPIPS-alex on random weights against the
   JAX evaluate of the same run); compact and densify_clone_split on path
   C's final map, on the card and on the CPU with the same split noise;
   paths E, F1 and F2, the port bench (gs_icp_slam_torch.bench) at
   training stages 0, 1 and 2 at bench.py's sizes on the JAX runs'
   recorded draws, each printing bench.py's JSON line and held
   before its refine to the JAX run of bench.py's flow; the four stress
   scenarios of tests/test_stress.py through FusedEngine.run, gated by
   that file's thresholds and held to the JAX runs; K1-fwd (bit-equal)
   and K1-bwd (within TOL_BWD_ROW) at a stage-1 opt view of path C's map
   (600x340, 209 tiles of 32, K 4,096), timed beside their bounds;
   K2 and K3 above 2^20 references also beside one library call
   (cdist + min / topk) each; each phase's seconds;
   path G, the command line as a user runs it: the 36 frames written in
   Replica's layout (JPEG colour, uint16 PNG depth, traj.txt,
   caminfo.txt), `python -m gs_icp_slam_torch run` on them (the Replica
   preset with bench.py's mapping settings, --save_results, a checkpoint)
   held bit for bit to FusedEngine.run on the same config and seed; a
   run autosaving at frame 12 and stopped there, resumed from the file by
   a new engine, within TOL_RESUME_M of the uninterrupted run; `render`
   of scene.ply along trajectory.npy (stride 6) with frame 18 held to the
   CPU's plain render, and `eval` of the renders against themselves; the
   network viewer serving a loopback client's 1200x680 request during an
   8-frame run, held to the CPU's render of the served map; checkpoint
   bytes, write and read times, save_ply and render times;
   path H, multi-device mapping (gs_icp_slam_torch.parallel): H1,
   FusedEngine on a world-1 mesh over NCCL in this process
   (init_distributed, global_mesh), in dp ("auto" picks it) and fsdp, on
   path C's scenario and draws (each iteration's batch draw repeats its
   pick), then one refine call: dp and fsdp bit for bit, ATE within
   TOL_H_ATE_M of path C and TOL_ATE_M of the JAX run, counts equal, PSNR
   within TOL_H1_PSNR_DB, no cap drop, and whether it equals path C bit
   for bit; H2, the same scenario on two processes sharing the one card
   over gloo (a group passed to make_mesh), TorchDraws(0) on both ranks:
   the ranks' poses, target, counts and keyframe store bit for bit, dp
   against fsdp within TOL_H_ATE_M / TOL_H2_PSNR_DB, each rank joined
   under H2_JOIN_S; on both, one opt_step_batched (dp, fsdp) and one
   make_parallel_opt_step on the final map against the plain
   single-process batched step (tests/test_parallel.py's tolerances),
   the bytes of their collectives (dp: one all-reduce of exactly the
   parameter bytes; fsdp: gathers of the parameters and live, a
   reduce-scatter of a 1/W shard, scalar all-reduces), ms per mapping
   iteration and per collective, FPS, each beside the card's name and
   power limit (two processes on one card measure no scaling);
5. prints a "kernels" JSON line (each row with its launches on paths
   A-H and the stress runs) and, as the last line,
   {"ok": true, "device": {...}}.  The card's name and power limit
   (nvidia-smi) is the first line of output.

Any failed check exits non-zero before the last line.  Without a CUDA
device, or without the gs_icp_slam_torch package beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings

# The JAX SLAMEngine on the same configurations (scripts/port_reference.py,
# JAX on the CPU): quality values, not speeds.  Path A, no mapping:
REF_A = dict(ate_m=0.0022180734651930383, num_gaussians=49680, kf_total=6,
             psnr_mean=8.240556557973227)
# Path B, 2 mapping iterations per frame, init opacity 0.5, feature lr 1e-2
# (scripts/port_reference.py --mapping-iters 2 --init-opacity 0.5
# --feature-lr 1e-2):
REF_B = dict(ate_m=0.0018647520233165142, num_gaussians=49680, kf_total=6,
             psnr_mean=23.574109925164116)
# Path C, FusedEngine on bench.py's scenario (scripts/port_reference.py
# --fused), and the random draws its step took, [maxval, value] in order,
# then the 64 draws of one refine call:
REF_C = dict(ate_m=0.0018625356366780827, num_gaussians=49680,
             kf_total=6, kf_count=6,
             psnr_mean=23.918221314748127, vis_cap_dropped=0,
             tile_cap_dropped=0)
DRAWS_C = [
    [64, 14], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0],
    [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0],
    [1, 0], [1, 0], [1, 0], [64, 58], [2, 1], [2, 0], [2, 0], [2, 1], [2, 1],
    [2, 0], [2, 0], [2, 0], [2, 0], [2, 0], [64, 21], [3, 2], [3, 1], [3, 0],
    [3, 2], [3, 2], [3, 1], [3, 2], [3, 0], [3, 2], [3, 0], [3, 0], [3, 2],
    [3, 0], [3, 0], [3, 2], [3, 2], [3, 0], [3, 2], [3, 0], [3, 1], [64, 25],
    [4, 3], [4, 3], [4, 0], [4, 0], [4, 2], [4, 2], [4, 0], [4, 1], [4, 3],
    [4, 1], [4, 0], [4, 2], [4, 1], [4, 2], [64, 19], [5, 0], [5, 0], [5, 4],
    [5, 3], [5, 4], [5, 3], [64, 7], [6, 1], [6, 1]]
REFINE_DRAWS_C = [
    [6, 5], [6, 4], [6, 3], [6, 3], [6, 3], [6, 0], [6, 3], [6, 2], [6, 5],
    [6, 1], [6, 1], [6, 1], [6, 4], [6, 5], [6, 4], [6, 2], [6, 1], [6, 3],
    [6, 5], [6, 2], [6, 1], [6, 2], [6, 5], [6, 0], [6, 0], [6, 2], [6, 4],
    [6, 3], [6, 2], [6, 0], [6, 5], [6, 1], [6, 1], [6, 0], [6, 5], [6, 3],
    [6, 4], [6, 0], [6, 4], [6, 0], [6, 2], [6, 0], [6, 3], [6, 1], [6, 3],
    [6, 2], [6, 4], [6, 3], [6, 0], [6, 5], [6, 2], [6, 1], [6, 2], [6, 4],
    [6, 1], [6, 3], [6, 3], [6, 2], [6, 0], [6, 0], [6, 0], [6, 4], [6, 1],
    [6, 3]]
# Tolerances: ATE within 0.5 mm and mean PSNR within 0.1 dB (float32 sums
# in another order, and near-tie neighbour picks of the XLA distance form
# the reference takes on the CPU); counts exact (a difference would be a
# different keyframe decision).
TOL_ATE_M = 5e-4
TOL_PSNR_DB = 0.1
# SSIM (mean, or per frame) and LPIPS (per frame, random alex weights,
# relative: its values are ~3e-3) of the port's map against the JAX map of
# the same run: the two maps differ by the runs' float32 drift
TOL_SSIM = 1e-3
TOL_LPIPS_REL = 1e-2
# densify_clone_split's split rows, card against CPU: a Cholesky factor
# and a 3x3 product in float32 (m)
TOL_SPLIT_M = 1e-6
# K1-bwd and the K4 backwards against their plain versions: each attribute
# row within this share of the row's largest |gradient| (pixel sums in
# another order)
TOL_BWD_ROW = 1e-4
# K4a/K4b forward against the numpy front-to-back oracle (float32, the same
# operation order; exp may differ by an ulp and flip a pair across the
# 1/255 alpha gate, worth up to ~4e-3 of a colour)
TOL_ORACLE = 5e-3

WIDTH, HEIGHT, FRAMES = 1200, 680, 36
MAPPING_ITERS = 2

# FusedEngine.evaluate on path C's run (scripts/port_reference.py --fused
# --evaluate): per-frame PSNR, SSIM and LPIPS-alex on the random weights
# make_random_weights(path, seed=0) writes
REF_EVAL_C = dict(
    per_frame_psnr=[
        19.497751235961914, 19.440574645996094, 19.447036743164062,
        19.526636123657227, 19.68819236755371, 19.95352554321289,
        20.369964599609375, 21.001483917236328, 22.001651763916016,
        23.702072143554688, 26.086341857910156, 26.14212989807129,
        26.240434646606445, 26.451459884643555, 26.731380462646484,
        27.001890182495117, 26.81766128540039, 26.58022117614746,
        26.371217727661133, 26.213825225830078, 26.084911346435547,
        26.016271591186523, 26.000688552856445, 26.003244400024414,
        26.21358299255371, 26.41077423095703, 25.731388092041016,
        25.119068145751953, 24.73027992248535, 24.458110809326172,
        24.210311889648438, 24.115135192871094, 23.880342483520508,
        22.229230880737305, 20.926206588745117, 19.660985946655273],
    per_frame_ssim=[
        0.5214211344718933, 0.5336886644363403, 0.5473036170005798,
        0.5622246265411377, 0.5788702964782715, 0.5970038771629333,
        0.6163208484649658, 0.6368424892425537, 0.6587660312652588,
        0.6819652915000916, 0.704308807849884, 0.7126346230506897,
        0.7228639125823975, 0.734636127948761, 0.7478117942810059,
        0.758327841758728, 0.7548540234565735, 0.7519700527191162,
        0.7505438327789307, 0.7513329982757568, 0.7532172203063965,
        0.7574055194854736, 0.7630304098129272, 0.7699320912361145,
        0.7795239090919495, 0.7870723605155945, 0.7867056131362915,
        0.7885085940361023, 0.7935900688171387, 0.7994789481163025,
        0.8058399558067322, 0.8146021962165833, 0.8221908807754517,
        0.8231440782546997, 0.8257194757461548, 0.8243990540504456],
    per_frame_lpips=[
        0.0027126874774694443, 0.002685976680368185, 0.0026488725561648607,
        0.00260611972771585, 0.0025106091052293777, 0.002388394670560956,
        0.0022351311054080725, 0.0020250072702765465, 0.0017465284327045083,
        0.0014303013449534774, 0.0012249264400452375, 0.0012224079109728336,
        0.0012138921301811934, 0.001188435242511332, 0.0011618948774412274,
        0.0011336894240230322, 0.0011884853010997176, 0.0012359037064015865,
        0.0012786666629835963, 0.0013110003201290965, 0.0013462137430906296,
        0.0013504396192729473, 0.0013656695373356342, 0.0013395961141213775,
        0.001275074784643948, 0.0012514563277363777, 0.0014273872366175056,
        0.0015932819806039333, 0.0017536681843921542, 0.0018918515415862203,
        0.0020215052645653486, 0.002116421004757285, 0.002200916176661849,
        0.002709985012188554, 0.0032392055727541447, 0.003842639736831188])
# bench.py's flow before its refine (scripts/port_reference.py
# --bench-stage S; F1's with --max-per-tile 1024) at stages 0, 1, 2 and
# bench.py's sizes; the draws of each run and of one refine call after it
# are path C's (the draws follow the keyframe decisions alone)
REF_E = dict(ate_rmse_m=0.0018625356366780827,
             psnr_pre_refine_db=23.918221314748127,
             psnr_pre_refine_min_db=19.44057273864746,
             ssim_pre_refine=0.7227238085534837, num_gaussians=49680,
             kf_total=6, kf_count=6, vis_cap_dropped=0, tile_cap_dropped=0)
REF_F1 = dict(ate_rmse_m=0.0018584208478529584,
              psnr_pre_refine_db=23.889074590471054,
              psnr_pre_refine_min_db=19.347190856933594,
              ssim_pre_refine=0.7239735109938515, num_gaussians=49680,
              kf_total=6, kf_count=6, vis_cap_dropped=0, tile_cap_dropped=0)
REF_F2 = dict(ate_rmse_m=0.0018820462094310414,
              psnr_pre_refine_db=22.11261494954427,
              psnr_pre_refine_min_db=18.360319137573242,
              ssim_pre_refine=0.690306598941485, num_gaussians=49680,
              kf_total=6, kf_count=6, vis_cap_dropped=0, tile_cap_dropped=0)
BENCH_PATHS = {"E": (0, REF_E), "F1": (1, REF_F1), "F2": (2, REF_F2)}
# tests/test_stress.py's scenarios through the JAX FusedEngine
# (scripts/port_reference.py --stress NAME), with their draws
REF_STRESS = {
    "depth_noise": dict(
        ate_m=0.009737371344887478, psnr_mean=26.795907974243164,
        num_gaussians=1368, kf_total=3, kf_count=3,
        vis_cap_dropped=0, tile_cap_dropped=0,
        draws=[
            [16, 14], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0],
            [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [16, 8], [2, 0], [2, 1],
            [2, 1], [2, 0], [2, 1], [2, 1], [2, 0], [2, 0], [2, 1], [2, 0],
            [16, 12], [3, 2], [3, 2], [3, 2], [3, 1], [3, 2], [3, 2], [3, 0],
            [3, 1], [3, 2], [3, 1], [3, 0], [3, 2], [3, 2], [3, 1], [3, 2],
            [3, 0], [3, 2], [3, 0], [3, 0], [3, 2], [3, 0], [3, 0], [3, 2],
            [3, 2], [3, 0], [3, 2], [3, 0], [3, 1], [3, 2], [3, 1], [3, 1],
            [3, 0], [3, 0], [3, 2], [3, 2], [3, 0], [3, 1], [3, 1], [3, 0],
            [3, 2], [3, 2], [3, 1], [3, 1], [3, 2], [3, 1], [3, 2], [3, 1],
            [3, 0], [3, 2], [3, 1], [3, 0], [3, 1], [3, 1], [3, 2], [3, 1],
            [3, 0], [3, 0], [3, 0], [3, 0], [3, 0], [3, 2], [3, 2], [3, 1],
            [3, 1], [3, 1], [3, 1]]),
    "rotation_heavy": dict(
        ate_m=0.008063147200914892, psnr_mean=22.54571278889974,
        num_gaussians=2280, kf_total=5, kf_count=5,
        vis_cap_dropped=0, tile_cap_dropped=0,
        draws=[
            [16, 14], [1, 0], [1, 0], [1, 0], [1, 0], [16, 5], [2, 1], [2, 1],
            [2, 0], [2, 0], [2, 0], [2, 0], [2, 0], [2, 0], [16, 4], [3, 2],
            [3, 2], [3, 1], [3, 0], [3, 1], [3, 0], [3, 2], [3, 2], [16, 4],
            [4, 0], [4, 3], [16, 13], [5, 4], [5, 0], [5, 4], [5, 4], [5, 0],
            [5, 1], [5, 3], [5, 2], [5, 0], [5, 2], [5, 0], [5, 4], [5, 1],
            [5, 2], [5, 3], [5, 0], [5, 3], [5, 3], [5, 0], [5, 3], [5, 3],
            [5, 4], [5, 4], [5, 2], [5, 2], [5, 3], [5, 3], [5, 1], [5, 0],
            [5, 4], [5, 2], [5, 2], [5, 4], [5, 2], [5, 1], [5, 4], [5, 1],
            [5, 1], [5, 3], [5, 0], [5, 4], [5, 0], [5, 0], [5, 0], [5, 4],
            [5, 3], [5, 4], [5, 3], [5, 3], [5, 1], [5, 0], [5, 2], [5, 0],
            [5, 2], [5, 0], [5, 1], [5, 3], [5, 4], [5, 1], [5, 4], [5, 3],
            [5, 4], [5, 0], [5, 2], [5, 0], [5, 0]]),
    "sparse_smooth": dict(
        ate_m=0.001614066176581473, psnr_mean=8.476389050483704,
        num_gaussians=3200, kf_total=4, kf_count=4,
        vis_cap_dropped=0, tile_cap_dropped=0,
        draws=[
            [16, 14], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0],
            [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0],
            [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [16, 10], [2, 1], [2, 0],
            [2, 0], [2, 1], [2, 1], [2, 0], [2, 0], [2, 0], [16, 10], [3, 0],
            [3, 1], [16, 1], [4, 1], [4, 0]]),
    "kf_overflow": dict(
        ate_m=0.0030421100548858114, psnr_mean=31.8311824798584,
        num_gaussians=3648, kf_total=8, kf_count=4,
        vis_cap_dropped=0, tile_cap_dropped=0,
        draws=[
            [4, 2], [1, 0], [1, 0], [4, 1], [2, 0], [2, 1], [2, 1], [2, 1],
            [4, 0], [3, 1], [3, 2], [3, 1], [3, 1], [4, 0], [4, 0], [4, 3],
            [4, 3], [4, 2], [4, 1], [4, 3], [4, 2], [4, 2], [4, 3], [4, 0],
            [4, 0], [4, 3], [4, 1], [4, 2], [4, 2], [4, 2], [4, 2], [4, 2],
            [4, 1], [4, 1], [4, 1], [4, 0], [4, 0], [4, 2], [4, 0], [4, 2],
            [4, 0], [4, 0], [4, 0], [4, 1], [4, 2], [4, 2], [4, 1], [4, 0],
            [4, 3], [4, 2], [4, 1], [4, 1], [4, 3], [4, 1], [4, 3], [4, 3],
            [4, 0], [4, 0], [4, 2], [4, 2], [4, 0], [4, 1], [4, 3], [4, 1],
            [4, 0], [4, 2], [4, 1], [4, 2], [4, 3], [4, 2], [4, 2], [4, 1],
            [4, 3], [4, 0], [4, 3], [4, 3], [4, 3], [4, 3], [4, 3], [4, 2],
            [4, 1], [4, 1], [4, 3], [4, 0], [4, 3], [4, 2], [4, 1], [4, 1],
            [4, 1], [4, 3], [4, 2], [4, 1], [4, 0], [4, 0], [4, 3], [4, 1],
            [4, 3], [4, 0], [4, 3], [4, 2]]),
}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float):
    """The least time (ms) of `flops` float32 operations and `nbytes`
    bytes at the H100's published peaks (utils/profiling.CHIPS), and which
    of the two bounds it."""
    from gs_icp_slam_torch.utils.profiling import CHIPS

    h100 = CHIPS["h100"]
    t_ops = flops / h100.peak_flops_f32 * 1e3
    t_mem = nbytes / (h100.hbm_gbps * 1e9) * 1e3
    return (max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")


# fp32 operations per (pixel, splat) pair of the compositor kernels, from
# their code (composite_common.cuh): every pair a pixel examines in the
# forward (offsets, power, gate, one exp); a pair that blends or stops
# (the whole forward arithmetic); every pair the backward walks (offsets,
# power, gate); and the rest of a pair that blended (exp, alpha, the ten
# terms)
OPS_EXAMINED, OPS_GATED, OPS_WALKED, OPS_BLENDED = 30.0, 40.0, 12.0, 45.0


def fwd_bounds(examined: int, gated: int, nbytes: float) -> dict:
    """A compositor forward's bounds: the row's, on the work the data needs
    (the pairs that blend or stop), and the old designs' basis (every pair
    examined)."""
    b, by = bound(gated * OPS_GATED, nbytes)
    b_e, by_e = bound(examined * OPS_EXAMINED, nbytes)
    return dict(bound_ms=b, bound_by=by, bound_ms_examined=b_e,
                bound_by_examined=by_e)


def bwd_bounds(walked: int, blended: int, nbytes: float) -> dict:
    """A compositor backward's bounds: the row's, on the pairs that blended
    (the whole per-pair arithmetic), and the old designs' basis (every
    pair walked, the blended ones' rest on top)."""
    b, by = bound(blended * (OPS_WALKED + OPS_BLENDED), nbytes)
    b_w, by_w = bound(walked * OPS_WALKED + blended * OPS_BLENDED, nbytes)
    return dict(bound_ms=b, bound_by=by, bound_ms_walked=b_w,
                bound_by_walked=by_w)


# K4a/K4b geometries: the rasterizer ablation's (scripts/profile_raster.py:
# 1200x680 in 16x16 tiles, 75 x 43 = 3,225 tiles, K 256) and the kernel
# smoke's (scripts/tpu_kernel_smoke.py: 48 tiles in rows of 8, K 128):
# (tiles, tiles per row, K, with counts)
DENSE_TILE = 16
DENSE_GEOMETRIES = {
    "K4a_ablation": (3225, 75, 256, False),
    "K4b_smoke": (48, 8, 128, True),
    "K4b_ablation": (3225, 75, 256, True),
}
DENSE_KERNELS = ("composite_dense_fwd", "composite_dense_bwd",
                 "composite_dyn_fwd", "composite_dyn_bwd")


def path_configs(seq, synthetic_config):
    """Paths A and B's configurations of the synthetic sequence seq:
    downsample 10, map capacity 2^18, target 2^16, visible cap 2^16,
    keyframe store 64; A without mapping, B with bench.py's mapping
    settings (2 iterations a frame, init opacity 0.5, feature lr 1e-2)."""
    base = synthetic_config(seq.intr, downsample_rate=10, capacity=1 << 18,
                            target_capacity=1 << 16, visible_capacity=1 << 16)
    cfg_a = base.replace(engine=dataclasses.replace(
        base.engine, mapping_iters_per_frame=0, mapping_iters_final=0,
        keyframe_capacity=64))
    cfg_b = cfg_a.replace(
        engine=dataclasses.replace(cfg_a.engine,
                                   mapping_iters_per_frame=MAPPING_ITERS),
        map=dataclasses.replace(cfg_a.map, init_opacity=0.5),
        opt=dataclasses.replace(cfg_a.opt, feature_lr=1e-2))
    return cfg_a, cfg_b


def dense_case(key: str):
    """Path D's inputs of one DENSE_GEOMETRIES entry: numpy counts and
    attrs (dense_inputs, seeded by the entry's place) and the torch
    gradient of out (seeded 3, rows 5-7 zero)."""
    import torch

    T, ntx, K, _ = DENSE_GEOMETRIES[key]
    seed = list(DENSE_GEOMETRIES).index(key) + 1
    counts_np, attrs_np = dense_inputs(T, ntx, DENSE_TILE, K, seed=seed)
    g = torch.randn((T, 8, DENSE_TILE ** 2),
                    generator=torch.Generator().manual_seed(3))
    g[:, 5:] = 0.0
    return counts_np, attrs_np, g


def dense_inputs(T, ntx, tile, K, seed):
    """K4 inputs as scripts/tpu_kernel_smoke.py:107-117 makes them, plus a
    zero-opacity tile (tile 2) and, through counts, an empty tile (0) and
    a full one (1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, size=(T,)).astype(np.int32)
    counts[[0, 1]] = (0, K)
    a = np.zeros((T, 16, K), np.float32)
    a[:, 0] = rng.uniform(0, ntx * tile, (T, K))
    a[:, 1] = rng.uniform(0, (T // ntx) * tile, (T, K))
    a[:, 2] = 0.05
    a[:, 4] = 0.05
    a[:, 5:8] = rng.uniform(0, 1, (T, 3, K))
    a[:, 8] = rng.uniform(0.1, 0.9, (T, K))
    a[:, 9] = rng.uniform(0.5, 5.0, (T, K))
    a[2, 8] = 0.0
    return counts, a


def oracle_rgb(a, count, t, ntx, tile):
    """numpy front-to-back composite of tile t's first `count` splats (the
    oracle of scripts/tpu_kernel_smoke.py:74-100, float32, with the done
    rule: the first splat that would take a pixel's transmittance below
    1e-4 stops the pixel)."""
    import numpy as np

    f32 = np.float32
    P = tile * tile
    pid = np.arange(P)
    px = ((t % ntx) * tile + pid % tile).astype(f32)
    py = ((t // ntx) * tile + pid // tile).astype(f32)
    tr = np.ones(P, f32)
    rgb = np.zeros((3, P), f32)
    done = np.zeros(P, bool)
    for k in range(count):
        s = a[:, k]
        dx, dy = px - s[0], py - s[1]
        power = f32(-0.5) * (s[2] * dx * dx + s[4] * dy * dy) - s[3] * dx * dy
        araw = s[8] * np.exp(np.minimum(power, f32(0)))
        gate = (power <= 0) & (araw >= f32(1.0 / 255.0)) & ~done
        alpha = np.where(gate, np.minimum(araw, f32(0.99)), f32(0))
        t_next = tr * (f32(1) - alpha)
        stop = gate & (t_next < f32(1e-4))
        done |= stop
        inc = gate & ~stop
        rgb += np.where(inc, alpha * tr, f32(0)) * s[5:8, None]
        tr = np.where(inc, t_next, tr)
    return rgb


def k4_view_inputs(eng, res, cfg, bin_splats, K=256, frame=18):
    """K4's real-view geometry: path B's map seen from frame `frame`'s
    estimated pose (the view of the K1-fwd phase), binned at 16-pixel
    tiles by the port's rasterizer, each tile's run packed front to back
    into a dense (T, 16, K) block; counts = the run lengths clipped at K,
    slots past a run zero (opacity 0).  Returns (counts, attrs, ntx, the
    runs clipped, the longest run)."""
    import torch

    m, rc, intr = eng.gmap, cfg.render, cfg.intr
    dev = m.xyz.device
    w2c = torch.linalg.inv(torch.as_tensor(res.poses[frame],
                                           dtype=torch.float32, device=dev))
    sh = torch.cat([m.f_dc[:, None, :], m.f_rest], dim=1)
    span = rc.tile_span * rc.tile_size // DENSE_TILE
    bn = bin_splats(m.xyz, m.rotation, torch.exp(m.log_scaling),
                    torch.sigmoid(m.opacity_logit[:, 0]), sh, w2c, m.live,
                    intr.fx, intr.fy, (intr.width - 1) / 2.0,
                    (intr.height - 1) / 2.0, sh_degree=cfg.map.sh_degree,
                    width=intr.width, height=intr.height, tile=DENSE_TILE,
                    visible_cap=rc.visible_capacity, tile_span=span,
                    tile_cap=rc.max_per_tile)
    T = bn.counts.shape[0]
    counts = torch.clamp(bn.counts, max=K).to(torch.int32)
    rank = torch.arange(K, device=dev)
    have = rank[None] < counts[:, None]
    rows = torch.where(have, bn.starts[:, None].long() + rank[None], 0)
    cols = torch.where(have, bn.pair_slot[rows].long(), 0)
    attrs = torch.zeros((T, 16, K), dtype=torch.float32, device=dev)
    attrs[:, :10] = torch.where(have[None], bn.attr_v[:10][:, cols],
                                0.0).permute(1, 0, 2)
    ntx = -(-intr.width // DENSE_TILE)
    return (counts.contiguous(), attrs.contiguous(), ntx,
            int((bn.counts > K).sum()), int(bn.counts.max()))


def dense_checks(name, c, attrs, g, ntx, composite_cuda, problems,
                 grad=None, counts_np=None, oracle_tiles=7):
    """K4a (c None) or K4b on one geometry: the forward bit-equal to its
    plain version, its counting call too, with evaluated + culled equal to
    the plain cull model's examined pairs and no pair lost; the numpy
    oracle on a few tiles; the backward within TOL_BWD_ROW of its plain
    version, equal bits on two launches (and to the entry point's
    gradient, grad), its (warp, rank) counts equal to the plain model's.
    Returns the forward's and backward's numbers for a row."""
    import numpy as np
    import torch

    args = (c, attrs, ntx, DENSE_TILE)
    out, nc = composite_cuda.composite_dense_fwd(*args)
    out0, nc0 = composite_cuda.composite_dense_fwd_plain(*args)
    oc, ncc, st_f = composite_cuda.composite_dense_fwd_counts(*args)
    _, _, model = composite_cuda.composite_dense_fwd_cull_plain(*args)
    torch.cuda.synchronize()
    err_f = float((out - out0).abs().max()) if out.numel() else 0.0
    if not (torch.equal(out, out0) and torch.equal(nc, nc0)):
        problems.append(f"{name} fwd: n_contrib differs at "
                        f"{int((nc != nc0).sum())} pixels, max |dout| "
                        f"{err_f} (tolerance: exact)")
    if not (torch.equal(oc, out0) and torch.equal(ncc, nc0)):
        problems.append(f"{name} fwd: the counting call differs from the "
                        "plain version")
    if (st_f["evaluated"] + st_f["culled"] != model["examined"]
            or model["lost"]):
        problems.append(f"{name} fwd: the kernel evaluated "
                        f"{st_f['evaluated']} and culled {st_f['culled']} "
                        f"pairs, the plain version examines "
                        f"{model['examined']}; the plain cull loses "
                        f"{model['lost']}")
    outs, an = out.cpu().numpy(), attrs.cpu().numpy()
    T, K = attrs.shape[0], attrs.shape[2]
    for t in range(0, T, max(1, T // oracle_tiles)):
        cnt = K if c is None else min(max(int(counts_np[t]), 0), K)
        err_o = float(np.abs(outs[t, 0:3] - oracle_rgb(
            an[t], cnt, t, ntx, DENSE_TILE)).max())
        if not err_o <= TOL_ORACLE:
            problems.append(f"{name} tile {t}: oracle mismatch {err_o}")
    bargs = (c, attrs, out, nc, g, ntx, DENSE_TILE)
    g1 = composite_cuda.composite_dense_bwd(*bargs)
    g2, st_b = composite_cuda.composite_dense_bwd_counts(*bargs)
    g0 = composite_cuda.composite_dense_bwd_plain(*bargs)
    ranks = composite_cuda.composite_dense_bwd_ranks_plain(c, attrs, nc, ntx,
                                                           DENSE_TILE)
    torch.cuda.synchronize()
    scale = g0[:, :10].abs().amax((0, 2)).clamp(min=1e-30)
    row_err = ((g1[:, :10] - g0[:, :10]).abs().amax((0, 2)) / scale).tolist()
    if not max(row_err) <= TOL_BWD_ROW:
        problems.append(f"{name} bwd: row errors {row_err} > {TOL_BWD_ROW}")
    if not torch.equal(g1, g2) or (grad is not None
                                   and not torch.equal(g1, grad)):
        problems.append(f"{name} bwd: two launches (or the entry point's "
                        "gradient) gave different bits")
    if st_b != ranks:
        problems.append(f"{name} bwd: the kernel walked/culled {st_b} "
                        f"(warp, rank) pairs, the plain model {ranks}")
    return dict(out=out, nc=nc, fwd_err=err_f, model=model, st_f=st_f,
                bwd_err=float((g1 - g0).abs().max()), row_err=row_err,
                st_b=st_b, deterministic=bool(torch.equal(g1, g2)))


def dense_times(c, attrs, g, ntx, chk, composite_cuda):
    """Times and bounds of K4a (c None) or K4b forward and backward on one
    geometry (dense_checks' results chk), CUDA events."""
    import torch

    T, _, K = attrs.shape
    P = DENSE_TILE ** 2
    args = (c, attrs, ntx, DENSE_TILE)
    bargs = (c, attrs, chk["out"], chk["nc"], g, ntx, DENSE_TILE)
    cnt = (torch.full((T,), K, device=attrs.device) if c is None
           else c.long().clamp(0, K))
    model = chk["model"]
    # rows 0-9 of the slots composited (and the counts) read, the output
    # and n_contrib written
    nbytes = (T * 4 * (c is not None) + int(cnt.sum()) * 10 * 4
              + T * 8 * P * 4 + T * P * 4)
    fwd = dict(ms=time_ms(lambda: composite_cuda.composite_dense_fwd(*args)),
               **fwd_bounds(model["examined"], model["gated"], nbytes),
               max_abs_err=chk["fwd_err"], pairs_examined=model["examined"],
               pairs_gated=model["gated"],
               pairs_evaluated=chk["st_f"]["evaluated"],
               pairs_culled=chk["st_f"]["culled"])
    walked, blended = composite_cuda.composite_dense_bwd_work(*bargs)
    cells = int(torch.minimum(chk["nc"].amax(1), cnt).sum())
    # rows 0-9 of the walked slots; t_final, n_contrib and g rows 0-4
    # read; the whole (T, 16, K) gradient written
    nbytes = cells * 10 * 4 + T * P * 4 * 7 + T * 16 * K * 4
    bwd = dict(ms=time_ms(lambda: composite_cuda.composite_dense_bwd(
                   *bargs)),
               **bwd_bounds(walked, blended, nbytes),
               max_abs_err=chk["bwd_err"], row_err_vs_row_max=chk["row_err"],
               deterministic=chk["deterministic"], pairs_walked=walked,
               pairs_blended=blended, cells_walked=cells,
               warp_ranks_walked=chk["st_b"]["walked"],
               warp_ranks_culled=chk["st_b"]["culled"])
    fwd["plain_ms"] = time_ms(
        lambda: composite_cuda.composite_dense_fwd_plain(*args), reps=2,
        warmup=1)
    bwd["plain_ms"] = time_ms(
        lambda: composite_cuda.composite_dense_bwd_plain(*bargs), reps=2,
        warmup=1)
    return fwd, bwd


def dense_kernel_phases(dense, view, launches_d, composite_cuda, problems):
    """K4a/K4b forward and backward against their plain versions (and the
    forward against the numpy oracle) on path D's inputs and on K4_view;
    timed beside their bounds.  Returns the four "kernels" entries."""
    rows = []
    for kind, key, line_fwd, line_bwd in (
            ("dense", "K4a_ablation", 101, 114),
            ("dyn", "K4b_ablation", 247, 289)):
        main = None
        for gname in (key, "K4b_smoke") if kind == "dyn" else (key,):
            d = dense[gname]
            c = d["counts"] if d["dyn"] else None
            chk = dense_checks(gname, c, d["attrs"], d["g"], d["ntx"],
                               composite_cuda, problems, grad=d["grad"],
                               counts_np=d["counts_np"])
            if gname == key:
                main = (c, d, chk)
        c, d, chk = main
        fwd, bwd = dense_times(c, d["attrs"], d["g"], d["ntx"], chk,
                               composite_cuda)
        vc = view["counts"] if kind == "dyn" else None
        vchk = dense_checks(f"K4_view {kind}", vc, view["attrs"], view["g"],
                            view["ntx"], composite_cuda, problems,
                            counts_np=view["counts_np"])
        vfwd, vbwd = dense_times(vc, view["attrs"], view["g"], view["ntx"],
                                 vchk, composite_cuda)
        geo = dict(tiles=d["T"], K=d["K"])
        vgeo = dict(tiles=view["attrs"].shape[0], K=view["attrs"].shape[2],
                    runs_clipped=view["clipped"], longest_run=view["longest"])
        for part, row, vrow, line in (("fwd", fwd, vfwd, line_fwd),
                                      ("bwd", bwd, vbwd, line_bwd)):
            name = f"composite_{kind}_{part}"
            rows.append(dict(
                name=name, route="cuda",
                source="gs_icp_slam_torch/csrc/composite_dense.cu",
                replaces=f"gs_icp_slam_tpu/ops/composite_pallas.py:{line}",
                launches=launches_d[name], library_ms=None, **row, **geo,
                k4_view=dict(**vrow, **vgeo)))
    return rows


def big_reference_phase(nn_cuda, problems) -> dict:
    """K2 and K3 above 2^20 references, where the kernels sort their chunks
    a segment at a time and K3 orders the cloud over several blocks: a
    random cube of 2^20 + 2^17 points, 30% of them invalid, searched by
    4,096 queries (K2, target and queries in Morton order, as G-ICP's
    are in space) and 2,048 (K3, k = 20) in the cube; exact against the plain versions, timed, with the
    all-pairs bound.  Returns {"nn1": ..., "knn": ...}."""
    import torch

    from gs_icp_slam_torch.ops.gicp import spatial_order

    dev = torch.device("cuda")
    R = (1 << 20) + (1 << 17)
    gen = torch.Generator(device="cpu").manual_seed(6)
    ref = (torch.rand((R, 3), generator=gen) * 4 - 2).to(dev)
    valid = (torch.rand(R, generator=gen) > 0.3).to(dev)
    q = (torch.rand((4096, 3), generator=gen) * 4 - 2).to(dev)
    nv = int(valid.sum())
    rv = ref[valid]
    rT, bias = nn_cuda.prepare_refs(ref, valid)
    args = (q, rT, bias, spatial_order(rT, valid), nn_cuda.morton_order(q))
    i1, d1 = nn_cuda.nn_search_pre(*args)
    i0, d0 = nn_cuda.nn1_plain(q, rT, bias, q_chunk=256)
    _, _, st = nn_cuda.nn1_search_counts(*args)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i0) and torch.equal(d1, d0)):
        problems.append(f"nn1 at {R} references: {int((i1 != i0).sum())} "
                        "indices differ (tolerance: exact)")
    b, by = bound(4096 * nv * 9.0, 4096 * 12 + R * 20 + 4096 * 8)
    out = {"nn1": dict(
        queries=4096, refs=R, valid_refs=nv,
        max_abs_err=float((d1 - d0).abs().max()),
        ms=time_ms(lambda: nn_cuda.nn_search_pre(*args)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_plain(q, rT, bias, q_chunk=256),
                         reps=1, warmup=0),
        # one library call: cdist to every valid reference, (4,096, nv)
        # in float32, then min
        library_ms=time_ms(lambda: torch.cdist(q, rv).min(dim=1),
                           reps=3, warmup=1),
        bound_ms_all_pairs=b, bound_by_all_pairs=by,
        chunks_culled=st["culled"], chunk_visits=st["visits"])}
    qk, k = q[:2048].contiguous(), 20
    i1, d1 = nn_cuda.knn_search_kernel(qk, ref, valid, k)
    i0, d0 = nn_cuda.knn_plain(qk, ref, valid, k, q_chunk=64)
    _, _, st = nn_cuda.knn_search_counts(qk, ref, valid, k)
    torch.cuda.synchronize()
    if not (torch.equal(i1, i0) and torch.equal(d1, d0)):
        problems.append(f"knn at {R} references: {int((i1 != i0).sum())} "
                        "indices differ (tolerance: exact)")
    b, by = bound(2048 * nv * 10.0, 2048 * 12 + R * 13 + 2048 * k * 8)
    out["knn"] = dict(
        queries=2048, refs=R, valid_refs=nv, k=k,
        max_abs_err=float((d1 - d0).abs().max()),
        ms=time_ms(lambda: nn_cuda.knn_search_kernel(qk, ref, valid, k)),
        plain_ms=time_ms(lambda: nn_cuda.knn_plain(qk, ref, valid, k,
                                                   q_chunk=64),
                         reps=1, warmup=0),
        library_ms=time_ms(lambda: torch.cdist(qk, rv).topk(
            k, dim=1, largest=False), reps=3, warmup=1),
        bound_ms_all_pairs=b, bound_by_all_pairs=by,
        chunks_culled=st["culled"], chunk_visits=st["visits"])
    print(json.dumps({"phase": "nn1 and knn above 2^20 references", **out}),
          flush=True)
    return out


def run_path_c(seq, cfg, FusedEngine, RecordedDraws, cuda_build, problems):
    """FusedEngine.run on bench.py's scenario with the JAX run's draws,
    held against REF_C; then one refine call.  Counts the host syncs of
    every fused step (torch.cuda sync debug mode: each blocking copy or
    stream synchronization inside the step), and keeps the arguments of
    the last K2 call of the Gauss-Newton loop (returned last)."""
    import numpy as np
    import torch

    from gs_icp_slam_torch.ops import gicp

    search = gicp.nn_search_pre
    last_nn = {}

    def recorded_search(*a):
        last_nn["args"] = a
        return search(*a)

    gicp.nn_search_pre = recorded_search
    cuda_build.reset_launch_counts()
    draws = RecordedDraws(DRAWS_C + REFINE_DRAWS_C)
    eng = FusedEngine(seq, cfg, device="cuda", draws=draws)
    step = eng.fused.step
    syncs, sites = [], {}

    def counted_step(*a):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = step(*a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        hits = [w for w in caught if "synchroniz" in str(w.message)]
        syncs.append(len(hits))
        for w in hits:  # the Python line that made each sync
            site = f"{w.filename.split('gs_icp_slam_torch/')[-1]}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
        return out

    eng.fused = eng.fused._replace(step=counted_step)
    t0 = time.perf_counter()
    try:
        res = eng.run(eval_render=True)
        torch.cuda.synchronize()
    finally:
        gicp.nn_search_pre = search
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    st = eng.state
    psnr_mean = float(res.psnr)
    print(json.dumps({
        "path": "C", "entry": "FusedEngine.run", "frames": FRAMES,
        "width": WIDTH, "height": HEIGHT,
        "mapping_iters_per_frame": cfg.engine.mapping_iters_per_frame,
        "opt_steps": st.train_iter, "fps": res.fps,
        "wall_s_with_render": wall, "ate_m": res.ate_rmse,
        "num_gaussians": res.num_gaussians, "kf_total": res.kf_total,
        "kf_count": res.kf_stored, "psnr_mean": psnr_mean,
        "psnr_min": float(res.per_frame_psnr.min()),
        "vis_cap_dropped": res.vis_cap_dropped,
        "tile_cap_dropped": res.tile_cap_dropped, "launches": launches,
        "opt_step_counters": eng.fused.counters,
        "host_syncs_per_frame": float(np.mean(syncs)),
        "host_syncs_by_frame": syncs, "host_sync_sites": dict(sorted(
            sites.items(), key=lambda kv: -kv[1])),
        "draws_used": draws.used}),
        flush=True)
    for k in ("nn1", "knn", "composite_fwd", "composite_bwd"):
        if launches[k] <= 0:
            problems.append(f"path C: kernel {k} was not launched")
    # every opt step runs K1-bwd once on the card; the host launches it
    # for an eager step and a capture, a graph replay relaunches it
    c = eng.fused.counters
    if (c["eager_opt_steps"] + c["replays"] != st.train_iter
            or launches["composite_bwd"] != c["eager_opt_steps"]
            + c["captures"]):
        problems.append(f"path C: composite_bwd launched "
                        f"{launches['composite_bwd']} times from the host, "
                        f"opt steps {c} for {st.train_iter} iterations")
    if not np.isfinite(res.poses).all():
        problems.append("path C: non-finite poses")
    if not abs(res.ate_rmse - REF_C["ate_m"]) <= TOL_ATE_M:
        problems.append(f"path C: ATE {res.ate_rmse} vs reference "
                        f"{REF_C['ate_m']}")
    for key, got in (("num_gaussians", res.num_gaussians),
                     ("kf_total", res.kf_total), ("kf_count", res.kf_stored)):
        if got != REF_C[key]:
            problems.append(f"path C: {key} {got} vs reference {REF_C[key]}")
    if not abs(psnr_mean - REF_C["psnr_mean"]) <= TOL_PSNR_DB:
        problems.append(f"path C: PSNR {psnr_mean} vs reference "
                        f"{REF_C['psnr_mean']}")
    for key, got in (("vis_cap_dropped", res.vis_cap_dropped),
                     ("tile_cap_dropped", res.tile_cap_dropped)):
        if got > REF_C[key]:
            problems.append(f"path C: {key} {got} above the reference's "
                            f"{REF_C[key]}")
    if draws.used != len(DRAWS_C):
        problems.append(f"path C: {draws.used} draws taken, the JAX run "
                        f"took {len(DRAWS_C)}")
    evaluate_phase(eng, cuda_build, problems)

    # one refine call: 64 mapping iterations, each one K1-bwd on the card
    cuda_build.reset_launch_counts()
    before = dict(c)
    n_bucket, _ = eng._pick_buckets(st.gmap.n)
    eng.state = eng.fused.refine(st, n_bucket)
    torch.cuda.synchronize()
    n_bwd = cuda_build.KERNELS["composite_bwd"].launches
    d = {k: c[k] - before[k] for k in c}
    finite = all(bool(torch.isfinite(p).all())
                 for p in (*eng.state.gmap[:6], *eng.state.adam.m.values(),
                           *eng.state.adam.v.values()))
    print(json.dumps({"path": "C", "entry": "FusedStep.refine",
                      "composite_bwd_launches": n_bwd,
                      "opt_step_counters": d,
                      "params_finite": finite,
                      "train_iter": eng.state.train_iter}), flush=True)
    if (d["eager_opt_steps"] + d["replays"] != 64
            or n_bwd != d["eager_opt_steps"] + d["captures"] or not finite):
        problems.append(f"refine: composite_bwd launched {n_bwd} times "
                        f"from the host, opt steps {d} (expected 64), "
                        f"parameters finite: {finite}")
    return eng, res, launches, syncs, last_nn["args"]


def launch_counts(cuda_build) -> dict:
    return {k.name: k.launches for k in cuda_build.KERNELS.values()}


def check_launched(name, launches, kernels_of_path, problems):
    for k in kernels_of_path:
        if launches[k] <= 0:
            problems.append(f"{name}: kernel {k} was not launched")


def evaluate_phase(eng, cuda_build, problems) -> dict:
    """FusedEngine.evaluate on path C's finished run (before its refine):
    per-frame PSNR, SSIM and LPIPS-alex (random weights that
    make_random_weights writes under build/) against REF_EVAL_C."""
    import os

    import numpy as np

    from gs_icp_slam_torch.eval.lpips import make_random_weights

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "lpips_random_alex.npz")
    make_random_weights(path, seed=0, net="alex")
    os.environ["GS_LPIPS_WEIGHTS"] = path
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        m = eng.evaluate(eval_stride=1)
    finally:
        del os.environ["GS_LPIPS_WEIGHTS"]
    launches = launch_counts(cuda_build)
    out = dict(psnr=m.psnr, ssim=m.ssim, lpips=m.lpips,
               per_frame_psnr=m.per_frame_psnr.tolist(),
               per_frame_ssim=m.per_frame_ssim.tolist(),
               per_frame_lpips=m.per_frame_lpips.tolist(),
               seconds=time.perf_counter() - t0,
               composite_fwd_launches=launches["composite_fwd"])
    print(json.dumps({"phase": "FusedEngine.evaluate after path C", **out}),
          flush=True)
    check_launched("evaluate", launches, ("composite_fwd",), problems)
    for key, tol, rel in (("per_frame_psnr", TOL_PSNR_DB, False),
                          ("per_frame_ssim", TOL_SSIM, False),
                          ("per_frame_lpips", TOL_LPIPS_REL, True)):
        ref = np.asarray(REF_EVAL_C[key])
        err = np.abs(np.asarray(out[key]) - ref)
        err = float((err / ref if rel else err).max())
        out[key + "_max_err"] = err
        if not err <= tol:
            problems.append(f"evaluate: {key} differs from JAX's by {err} "
                            f"(tolerance {tol})")
    return out


def bench_path(name, card, cuda_build, problems) -> dict:
    """The port bench (gs_icp_slam_torch.bench.run_bench) at bench.py's
    sizes and a path's training stage (BENCH_PATHS), on the JAX run's
    draws (path C's), then one refine call's, then a TorchDraws stream
    (the wall-capped refine may take more calls): its JSON line beside
    the card, and its state before the refine against the JAX run of
    bench.py's flow."""
    import numpy as np

    from gs_icp_slam_torch.bench import bench_line, run_bench
    from gs_icp_slam_torch.slam import RecordedDraws, TorchDraws

    stage, ref = BENCH_PATHS[name]
    draws = RecordedDraws(DRAWS_C + REFINE_DRAWS_C, then=TorchDraws(0))
    env = {"GS_BENCH_STAGE": str(stage)}
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    run = run_bench(draws=draws, device="cuda", env=env)
    seconds = time.perf_counter() - t0
    launches = launch_counts(cuda_build)
    pre = {k: v for k, v in run.pre_refine.items() if k != "poses"}
    print(json.dumps(bench_line(run.fields)), flush=True)
    print(json.dumps({"path": name, "entry": "gs_icp_slam_torch.bench."
                      "run_bench", "training_stage": stage,
                      "width": WIDTH, "height": HEIGHT, "frames": FRAMES,
                      "card": card,
                      "seconds": seconds, "launches": launches,
                      "fields": run.fields, "pre_refine": pre}), flush=True)
    check_launched(f"path {name}", launches,
                   ("nn1", "knn", "composite_fwd", "composite_bwd"),
                   problems)
    if not np.isfinite(run.pre_refine["poses"]).all():
        problems.append(f"path {name}: non-finite poses")
    for key, tol in (("ate_rmse_m", TOL_ATE_M),
                     ("psnr_pre_refine_db", TOL_PSNR_DB),
                     ("psnr_pre_refine_min_db", TOL_PSNR_DB),
                     ("ssim_pre_refine", TOL_SSIM)):
        if not abs(pre[key] - ref[key]) <= tol:
            problems.append(f"path {name}: {key} {pre[key]} vs JAX "
                            f"{ref[key]} (tolerance {tol})")
    for key in ("num_gaussians", "kf_total", "kf_count", "vis_cap_dropped",
                "tile_cap_dropped"):
        if pre[key] != ref[key]:
            problems.append(f"path {name}: {key} {pre[key]} vs JAX "
                            f"{ref[key]}")
    if draws.used < len(DRAWS_C):
        problems.append(f"path {name}: {draws.used} draws taken, the JAX "
                        f"run took {len(DRAWS_C)}")
    return dict(launches=launches, pre_refine=pre, fields=run.fields)


def stage1_view_inputs(eng, cfg_b):
    """A stage-1 opt view: path C's map (eng.state) and its newest stored
    keyframe, one opt step of the stage-1 mapping primitives (600x340, 209
    tiles of 32, K 4,096); returns the K1-fwd and K1-bwd arguments that the
    step handed the kernels."""
    import torch

    from gs_icp_slam_torch.models import map_params
    from gs_icp_slam_torch.ops import composite_cuda
    from gs_icp_slam_torch.slam.fused import make_mapping_primitives

    cfg1 = cfg_b.replace(opt=dataclasses.replace(cfg_b.opt,
                                                 training_stage=1))
    prim = make_mapping_primitives(cfg1, "cuda")
    st = eng.state
    captured = {}
    fwd, bwd = composite_cuda.composite_fwd, composite_cuda.composite_bwd

    def record_fwd(*a):
        captured["fwd"] = a
        return fwd(*a)

    def record_bwd(*a):
        captured["bwd"] = a
        return bwd(*a)

    composite_cuda.composite_fwd = record_fwd
    composite_cuda.composite_bwd = record_bwd
    try:
        kf = st.kf_count - 1
        prim.opt_step(map_params(st.gmap), st.adam, st.gmap.live,
                      st.kf_w2c[kf], st.kf_rgb[kf], st.kf_depth[kf])
        torch.cuda.synchronize()
    finally:
        composite_cuda.composite_fwd = fwd
        composite_cuda.composite_bwd = bwd
    return (tuple(a.detach() if torch.is_tensor(a) else a
                  for a in captured["fwd"]),
            tuple(a.detach() if torch.is_tensor(a) else a
                  for a in captured["bwd"]))


def opt_step_times(eng, cfg_b, reps: int = 10) -> dict:
    """One opt step (render, loss, backward, Adam) at training stages 0, 1
    and 2 on path C's map, its capacity bucket and its newest keyframe:
    the host clock around reps steps that end in a synchronize (ms)."""
    import torch

    from gs_icp_slam_torch.models import map_params
    from gs_icp_slam_torch.slam.fused import make_mapping_primitives

    st = eng.state
    nb = eng._pick_buckets(st.gmap.n)[0] or st.gmap.capacity
    params = {k: v[:nb] for k, v in map_params(st.gmap).items()}
    adam = st.adam._replace(m={k: v[:nb] for k, v in st.adam.m.items()},
                            v={k: v[:nb] for k, v in st.adam.v.items()})
    kf = st.kf_count - 1
    view = (st.gmap.live[:nb], st.kf_w2c[kf], st.kf_rgb[kf], st.kf_depth[kf])
    out = {}
    for stage in (0, 1, 2):
        cfg = cfg_b.replace(opt=dataclasses.replace(cfg_b.opt,
                                                    training_stage=stage))
        step = make_mapping_primitives(cfg, "cuda", n_cap=nb).opt_step
        for _ in range(2):
            step(params, adam, *view)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step(params, adam, *view)
        torch.cuda.synchronize()
        out[stage] = (time.perf_counter() - t0) / reps * 1e3
    return out


def stage1_k1_phase(eng, cfg_b, composite_cuda, problems) -> dict:
    """K1-fwd and K1-bwd at a stage-1 opt view (209 tiles, K 4,096): the
    forward bit-equal to its plain version, its evaluated + culled pairs
    adding up to the plain cull model's examined ones; the backward within
    TOL_BWD_ROW of each row's largest |gradient| of its plain version, equal
    bits on two launches; times and bounds on PERF.md §6's basis."""
    import torch

    cargs, bargs = stage1_view_inputs(eng, cfg_b)
    counts, attr, tile = cargs[0], cargs[3], cargs[5]
    o1, nc1 = composite_cuda.composite_fwd(*cargs)
    o0, nc0 = composite_cuda.composite_fwd_plain(*cargs)
    _, _, st_f = composite_cuda.composite_fwd_counts(*cargs)
    _, _, model = composite_cuda.composite_fwd_cull_plain(*cargs)
    torch.cuda.synchronize()
    T, P = counts.shape[0], tile * tile
    fwd_err = float((o1 - o0).abs().max())
    if not (torch.equal(o1, o0) and torch.equal(nc1, nc0)):
        problems.append(f"stage-1 composite_fwd: max |dout| {fwd_err}, "
                        f"n_contrib differs at {int((nc1 != nc0).sum())} "
                        "pixels (tolerance: exact)")
    if (st_f["evaluated"] + st_f["culled"] != model["examined"]
            or model["lost"]):
        problems.append(f"stage-1 composite_fwd: evaluated "
                        f"{st_f['evaluated']} + culled {st_f['culled']} vs "
                        f"examined {model['examined']}, lost "
                        f"{model['lost']}")
    nbytes = (T * 8 + int(counts.sum()) * 4 + attr.numel() * 4
              + T * 8 * P * 4)
    fwd = dict(max_count=int(counts.max()), mean_count=float(
                   counts.float().mean()), max_abs_err=fwd_err,
               ms=time_ms(lambda: composite_cuda.composite_fwd(*cargs)),
               plain_ms=time_ms(lambda: composite_cuda.composite_fwd_plain(
                   *cargs), reps=2, warmup=1),
               **fwd_bounds(model["examined"], model["gated"], nbytes),
               pairs_examined=model["examined"], pairs_gated=model["gated"],
               pairs_evaluated=st_f["evaluated"],
               pairs_culled=st_f["culled"])
    pargs = bargs[:9]
    d1 = composite_cuda.composite_bwd(*bargs)
    d2 = composite_cuda.composite_bwd(*bargs)
    d0 = composite_cuda.composite_bwd_plain(*pargs)
    torch.cuda.synchronize()
    row_scale = d0[:10].abs().amax(1).clamp(min=1e-30)
    row_err = ((d1[:10] - d0[:10]).abs().amax(1) / row_scale).tolist()
    if not max(row_err) <= TOL_BWD_ROW:
        problems.append(f"stage-1 composite_bwd: row errors {row_err} > "
                        f"{TOL_BWD_ROW}")
    if not torch.equal(d1, d2):
        problems.append("stage-1 composite_bwd: two launches gave different "
                        "bits")
    walked, blended = composite_cuda.composite_bwd_work(*pargs)
    b_nc, rows = bargs[5], bargs[9]
    nsub = (-(-tile // min(tile, composite_cuda.BWD_SIDE))) ** 2
    cell_bytes = int(counts.sum()) * nsub * 10 * 4
    nbytes_b = (T * 8 + int(counts.sum()) * 4 + attr.numel() * 4
                + T * P * 4 * 7 + rows.numel() * 4 + 2 * cell_bytes
                + attr.numel() * 4)
    bwd = dict(max_abs_err=float((d1 - d0).abs().max()),
               row_err_vs_row_max=row_err,
               deterministic=bool(torch.equal(d1, d2)),
               ms=time_ms(lambda: composite_cuda.composite_bwd(*bargs)),
               plain_ms=time_ms(lambda: composite_cuda.composite_bwd_plain(
                   *pargs), reps=2, warmup=1),
               **bwd_bounds(walked, blended, nbytes_b),
               pairs_walked=walked, pairs_blended=blended,
               max_n_contrib=int(b_nc.max()))
    geo = dict(width=cfg_b.intr.width // 2, height=cfg_b.intr.height // 2,
               tiles=T, tile_cap_K=cfg_b.render.max_per_tile)
    print(json.dumps({"phase": "K1 at a stage-1 opt view", **geo,
                      "composite_fwd": fwd, "composite_bwd": bwd,
                      "opt_step_ms_by_stage": opt_step_times(eng, cfg_b)}),
          flush=True)
    return dict(composite_fwd=dict(**geo, **fwd),
                composite_bwd=dict(**geo, **bwd))


# tests/test_stress.py's thresholds: ATE below (m), mean PSNR above (dB)
STRESS_GATES = {"depth_noise": (0.02, 18.0), "rotation_heavy": (0.05, None),
                "sparse_smooth": (0.005, None), "kf_overflow": (0.01, 15.0)}


def stress_phase(cuda_build, problems) -> dict:
    """The four stress scenarios through FusedEngine.run on the card, with
    the JAX runs' draws: tests/test_stress.py's thresholds as hard gates,
    and agreement with the JAX run of each (REF_STRESS) under PERF.md §2."""
    import numpy as np

    from gs_icp_slam_torch.bench import STRESS, stress_config
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import open_dataset
    from gs_icp_slam_torch.slam import FusedEngine, RecordedDraws

    out = {}
    for name, kw in STRESS.items():
        seq, cfg = stress_config(synthetic_config, open_dataset, **kw)
        ref = REF_STRESS[name]
        draws = RecordedDraws(ref["draws"])
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        eng = FusedEngine(seq, cfg, device="cuda", draws=draws)
        res = eng.run(eval_render=True, eval_stride=4)
        seconds = time.perf_counter() - t0
        launches = launch_counts(cuda_build)
        kf_rgb = eng.state.kf_rgb.float().reshape(
            eng.state.kf_rgb.shape[0], -1)
        textured = int((kf_rgb.std(dim=1) > 0).sum())
        row = dict(ate_m=res.ate_rmse, psnr_mean=res.psnr,
                   num_gaussians=res.num_gaussians, kf_total=res.kf_total,
                   kf_count=res.kf_stored,
                   vis_cap_dropped=res.vis_cap_dropped,
                   tile_cap_dropped=res.tile_cap_dropped,
                   kf_slots_textured=textured, seconds=seconds,
                   launches=launches)
        print(json.dumps({"phase": f"stress {name}", **row}), flush=True)
        out[name] = row
        check_launched(f"stress {name}", launches,
                       ("nn1", "knn", "composite_fwd", "composite_bwd"),
                       problems)
        ate_max, psnr_min = STRESS_GATES[name]
        if not (np.isfinite(res.poses).all() and res.ate_rmse < ate_max):
            problems.append(f"stress {name}: ATE {res.ate_rmse} not below "
                            f"{ate_max}")
        if psnr_min is not None and not res.psnr > psnr_min:
            problems.append(f"stress {name}: PSNR {res.psnr} not above "
                            f"{psnr_min}")
        if name == "kf_overflow" and not (
                res.kf_total > res.kf_stored == 4 and textured == 4):
            problems.append(f"stress {name}: {res.kf_total} keyframes, "
                            f"{res.kf_stored} stored, {textured} textured")
        if not abs(res.ate_rmse - ref["ate_m"]) <= TOL_ATE_M:
            problems.append(f"stress {name}: ATE {res.ate_rmse} vs JAX "
                            f"{ref['ate_m']}")
        if not abs(res.psnr - ref["psnr_mean"]) <= TOL_PSNR_DB:
            problems.append(f"stress {name}: PSNR {res.psnr} vs JAX "
                            f"{ref['psnr_mean']}")
        for key in ("num_gaussians", "kf_total", "kf_count"):
            if row[key] != ref[key]:
                problems.append(f"stress {name}: {key} {row[key]} vs JAX "
                                f"{ref[key]}")
        for key in ("vis_cap_dropped", "tile_cap_dropped"):
            if row[key] > ref[key]:
                problems.append(f"stress {name}: {key} {row[key]} above "
                                f"JAX's {ref[key]}")
        if draws.used != len(ref["draws"]):
            problems.append(f"stress {name}: {draws.used} draws taken, the "
                            f"JAX run took {len(ref['draws'])}")
    return out


def maintenance_phase(eng, problems) -> dict:
    """compact (with Adam's moments) and densify_clone_split on path C's
    final map, on the card and on the CPU with the same split noise: equal
    (split rows' positions within TOL_SPLIT_M).  The trigger is each
    slot's Adam first moment of xyz, by norm; the public function draws its
    noise on the card once more."""
    import torch

    from gs_icp_slam_torch.models import gaussian_map as gm

    m, adam = eng.state.gmap, eng.state.adam
    grad = adam.m["xyz"].norm(dim=1)
    thr = float(torch.quantile(grad[m.live], 0.99))
    eps = torch.randn((2, 4096, 3), generator=torch.Generator().manual_seed(9))
    cpu = gm.GaussianMap(*(x.cpu() if torch.is_tensor(x) else x for x in m))
    t0 = time.perf_counter()
    got = gm.densify_clone_split_with_noise(m, grad, 2.5, eps.cuda(),
                                            grad_threshold=thr)
    want = gm.densify_clone_split_with_noise(cpu, grad.cpu(), 2.5, eps,
                                             grad_threshold=thr)
    drawn = gm.densify_clone_split(m, grad, 2.5, torch.Generator(
        device="cuda").manual_seed(9), grad_threshold=thr)
    trees = ({k: v for k, v in adam.m.items()},
             {k: v for k, v in adam.v.items()})
    c_got = gm.compact(got, extra_trees=[trees])
    c_want = gm.compact(want, extra_trees=[tuple(
        {k: v.cpu() for k, v in t.items()} for t in trees)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # a split row of a Gaussian whose covariance is not numerically
    # positive definite has a NaN position, as in the JAX function: the
    # NaN rows must match, the rest within TOL_SPLIT_M
    pairs = ((got.xyz.cpu(), want.xyz), (c_got[0].xyz.cpu(), c_want[0].xyz))
    nan_rows = int(want.xyz.isnan().any(1).sum())
    same_nan = all(torch.equal(a.isnan(), b.isnan()) for a, b in pairs)
    split_err = max(float((a - b).nan_to_num().abs().max())
                    for a, b in pairs)
    same = all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
               for a, b in ((got, want), (c_got[0], c_want[0]))
               for f in m._fields if f not in ("n", "xyz"))
    same &= all(torch.equal(a[k].cpu(), b[k]) for a, b in
                zip(c_got[1], c_want[1]) for k in a)
    out = dict(live_before=m.num_live, n_before=m.n,
               grad_threshold=thr, n_after=got.n, live_after=got.num_live,
               live_after_drawn_noise=drawn.num_live,
               compact_n=c_got[0].n, split_rows_max_err_m=split_err,
               split_rows_nan=nan_rows, seconds=seconds)
    print(json.dumps({"phase": "densify_clone_split and compact on path "
                      "C's map", **out}), flush=True)
    if not (same and same_nan and got.n == want.n
            and c_got[0].n == c_want[0].n and split_err <= TOL_SPLIT_M):
        problems.append(f"maintenance: the card differs from the CPU "
                        f"(other fields equal: {same}, NaN rows equal: "
                        f"{same_nan}, positions within {split_err} m)")
    if not got.n > m.n or drawn.n != got.n:
        problems.append(f"maintenance: densify added {got.n - m.n} rows, "
                        f"with drawn noise {drawn.n - m.n}")
    return out


# ---- path G: the command line as a user runs it ------------------------

# tolerances of path G: a resumed run's poses against the uninterrupted
# run's (the same state and draw position; bit-equal where every launch
# is deterministic), and a card render against the CPU's plain path for
# the same map and pose (float32 projection arithmetic rounds differently
# on the two devices; the uint8 rounding shows it in few pixels)
TOL_RESUME_M = 1e-5
TOL_U8_LEVELS, TOL_U8_PIXELS = 1, 1e-3


def write_replica_dir(seq, root: str) -> str:
    """The synthetic sequence in Replica's layout (ReplicaSequence reads
    it): images/frame%06d.jpg colour at JPEG quality 95,
    depth_images/depth%06d.png uint16 raw depth (the sequence's depth
    scale), traj.txt one flattened c2w per line; and caminfo.txt naming
    replica with the sequence's intrinsics.  Returns caminfo.txt's path."""
    import os

    import numpy as np
    from PIL import Image

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depth_images"))
    rows = []
    for i in range(len(seq)):
        fr = seq[i]
        Image.fromarray(fr.rgb).save(
            os.path.join(root, "images", f"frame{i:06d}.jpg"), quality=95)
        Image.fromarray(np.round(fr.depth).astype(np.uint16)).save(
            os.path.join(root, "depth_images", f"depth{i:06d}.png"))
        rows.append(" ".join(repr(float(v)) for v in fr.gt_c2w.reshape(-1)))
    with open(os.path.join(root, "traj.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    intr = seq.intr
    caminfo = os.path.join(root, "caminfo.txt")
    with open(caminfo, "w") as f:
        f.write("# camera\n# W H fx fy cx cy depth_scale depth_trunc type\n"
                f"{intr.width} {intr.height} {intr.fx!r} {intr.fy!r} "
                f"{intr.cx!r} {intr.cy!r} {intr.depth_scale!r} "
                f"{intr.depth_trunc!r} replica\n")
    return caminfo


def cli_main(argv) -> tuple:
    """gs_icp_slam_torch.cli.main(argv) on the card: (its exit code, what
    it printed, the seconds it took); the printed lines are echoed."""
    import contextlib
    import io

    import torch

    from gs_icp_slam_torch.cli import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"  cli: {line}", flush=True)
    return rc, buf.getvalue(), seconds


def u8_agreement(a, b) -> dict:
    """Two uint8 images: the largest level difference and the share of
    pixels that differ at all."""
    import numpy as np

    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return dict(max_levels=int(d.max()),
                pixels_differing=float((d.max(axis=-1) > 0).mean()))


def u8_within(agree) -> bool:
    return (agree["max_levels"] <= TOL_U8_LEVELS
            and agree["pixels_differing"] <= TOL_U8_PIXELS)


def path_g(seq, card, cuda_build, problems) -> dict:
    """Path G: the command line as a user runs it, on the card, at
    bench.py's geometry.  The synthetic sequence written in Replica's
    layout; `run` (the Replica preset with bench.py's mapping settings,
    --save_results, a checkpoint) held bit for bit to FusedEngine.run on
    the same config and seed; a run autosaving at frame 12 and stopped
    there, resumed from the file by a new engine, held to the
    uninterrupted run; `render` of scene.ply along trajectory.npy at
    stride 6, one frame held to the CPU's plain render, and `eval` of the
    renders against themselves; FusedEngine.run with a NetworkGUI over 8
    frames, serving a loopback client's 1200x680 request, held to the
    CPU's render of the served map.  Returns the launches of every step,
    summed per kernel."""
    import os
    import shutil
    import socket
    import threading

    import numpy as np
    import PIL
    import torch
    from PIL import Image

    from gs_icp_slam_torch.config import parse_caminfo, replica_config
    from gs_icp_slam_torch.datasets import ReplicaSequence
    from gs_icp_slam_torch.eval.offline import render_ply_sequence
    from gs_icp_slam_torch.io import checkpoint as ckpt
    from gs_icp_slam_torch.io.ply import load_ply
    from gs_icp_slam_torch.slam import FusedEngine
    from gs_icp_slam_torch.viz import network_gui

    g = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "path_g")
    shutil.rmtree(g, ignore_errors=True)
    data, out = os.path.join(g, "replica"), os.path.join(g, "out")
    t0 = time.perf_counter()
    caminfo = write_replica_dir(seq, data)
    print(json.dumps({"path": "G", "step": "input", "form": "replica",
                      "layout": "images/frame%06d.jpg (JPEG q95), "
                      "depth_images/depth%06d.png (uint16), traj.txt, "
                      "caminfo.txt", "pil": PIL.__version__,
                      "frames": len(seq), "seconds":
                      time.perf_counter() - t0}), flush=True)
    total = {}

    def counted(step, kernels):
        launches = launch_counts(cuda_build)
        check_launched(f"path G {step}", launches, kernels, problems)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        return launches

    # ---- run, through the command line and directly ---------------------
    ck_end = os.path.join(out, "checkpoint.npz")
    cuda_build.reset_launch_counts()
    rc, printed, cli_s = cli_main([
        "run", "--dataset_path", data, "--config", caminfo, "--frames",
        str(FRAMES), "--unlimited", "--mapping_iters_per_frame",
        str(MAPPING_ITERS), "--init_opacity", "0.5", "--feature_lr", "1e-2",
        "--capacity", str(1 << 18), "--save_results", "--output_path", out,
        "--checkpoint_path", ck_end])
    run_launches = counted("run", ("nn1", "knn", "composite_fwd",
                                   "composite_bwd"))
    if rc != 0:
        problems.append(f"path G: run exited {rc}")
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    traj = np.load(os.path.join(out, "trajectory.npy"))
    with np.load(ck_end) as z:  # reads these members only
        end = {k: int(z[f"s.{k}"]) for k in (
            "kf_total", "kf_count", "stat_vis_dropped", "stat_pair_dropped")}

    intr, kind = parse_caminfo(caminfo)
    cfg = replica_config(intr)
    cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, capacity=1 << 18, init_opacity=0.5),
        opt=dataclasses.replace(cfg.opt, feature_lr=1e-2),
        engine=dataclasses.replace(cfg.engine, fps_cap=None,
                                   mapping_iters_per_frame=MAPPING_ITERS))
    dataset = ReplicaSequence(data, intr=intr, max_frames=FRAMES)
    cuda_build.reset_launch_counts()
    direct = FusedEngine(dataset, cfg, seed=0, device="cuda")
    res = direct.run(eval_render=True)
    metrics = direct.evaluate(eval_stride=1, poses=res.poses)
    counted("direct run", ("nn1", "knn", "composite_fwd", "composite_bwd"))
    st = direct.state
    t0 = time.perf_counter()
    n_rows = direct.save_ply(os.path.join(g, "direct.ply"))
    save_ply_s = time.perf_counter() - t0
    with open(os.path.join(g, "direct.ply"), "rb") as f:
        direct_ply = f.read()
    with open(os.path.join(out, "scene.ply"), "rb") as f:
        same_ply = f.read() == direct_ply
    same = dict(
        trajectory=bool(np.array_equal(traj, res.poses)), ply=same_ply,
        num_gaussians=results["num_gaussians"] == res.num_gaussians,
        frames=results["frames"] == len(res.poses) == FRAMES,
        ate_rmse_cm=results["ate_rmse_cm"] == res.ate_rmse * 100,
        psnr=results["psnr"] == metrics.psnr,
        ssim=results["ssim"] == metrics.ssim,
        kf_total=end["kf_total"] == st.kf_total,
        kf_count=end["kf_count"] == st.kf_count,
        vis_cap_dropped=end["stat_vis_dropped"] == res.vis_cap_dropped,
        tile_cap_dropped=end["stat_pair_dropped"] == res.tile_cap_dropped)
    print(json.dumps({
        "path": "G", "step": "run", "entry": "gs_icp_slam_torch.cli.main "
        "run", "card": card, "dataset_type": kind, "exit_code": rc,
        "printed_fps_line": printed.splitlines()[0], "results": results,
        "cli_seconds": cli_s, "direct_fps": res.fps,
        "direct_ate_m": res.ate_rmse, "direct_kf_total": res.kf_total,
        "equal_to_direct_run": same, "save_ply_rows": n_rows,
        "save_ply_bytes": len(direct_ply), "save_ply_s": save_ply_s,
        "launches": run_launches}), flush=True)
    for key, ok in same.items():
        if not ok:
            problems.append(f"path G: run's {key} differs from the direct "
                            "FusedEngine run's")
    if kind != "replica" or not printed.startswith("System FPS: "):
        problems.append(f"path G: run read a {kind} caminfo and printed "
                        f"{printed.splitlines()[:1]}")

    # ---- autosave at frame 12, stop, resume -----------------------------
    ck12 = os.path.join(g, "autosave.npz")
    save = ckpt.save_fused_state
    stop = {}

    class Stop(Exception):
        pass

    def save_then_stop(state, path, draws=None, buckets=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(state, path, draws, buckets)
        stop.update(frame_idx=state.frame_idx,
                    write_s=time.perf_counter() - t)
        raise Stop

    cuda_build.reset_launch_counts()
    ckpt.save_fused_state = save_then_stop
    try:
        FusedEngine(dataset, cfg, seed=0, device="cuda").run(
            eval_render=False, checkpoint_every=12, checkpoint_path=ck12)
    except Stop:
        pass
    finally:
        ckpt.save_fused_state = save
    load = ckpt.load_fused_state

    def timed_load(*a, **kw):
        t = time.perf_counter()
        state = load(*a, **kw)
        torch.cuda.synchronize()
        stop["read_s"] = time.perf_counter() - t
        return state

    resumed = FusedEngine(dataset, cfg, seed=0, device="cuda")
    ckpt.load_fused_state = timed_load  # the engine imports it in run()
    try:
        res_r = resumed.run(eval_render=False, resume_from=ck12)
    finally:
        ckpt.load_fused_state = load
    resume_launches = counted("resume", ("nn1", "knn", "composite_fwd",
                                         "composite_bwd"))
    pose_err = float(np.abs(res_r.poses - res.poses).max())
    counts_equal = (res_r.num_gaussians, res_r.kf_total, res_r.kf_stored) \
        == (res.num_gaussians, res.kf_total, res.kf_stored)
    print(json.dumps({
        "path": "G", "step": "resume", "card": card,
        "stopped_after_save_at_frame": stop.get("frame_idx"),
        "checkpoint_bytes": os.path.getsize(ck12),
        "checkpoint_write_s": stop.get("write_s"),
        "checkpoint_read_s": stop.get("read_s"), "max_pose_err_m": pose_err,
        "bit_equal": bool(np.array_equal(res_r.poses, res.poses)),
        "counts_equal": counts_equal, "launches": resume_launches}),
        flush=True)
    if stop.get("frame_idx") != 12:
        problems.append(f"path G: the autosave ran at frame "
                        f"{stop.get('frame_idx')}, not 12")
    if not (pose_err <= TOL_RESUME_M and counts_equal):
        problems.append(f"path G: the resumed run's poses differ by "
                        f"{pose_err} m (tolerance {TOL_RESUME_M}), counts "
                        f"equal: {counts_equal}")

    # ---- render and eval --------------------------------------------------
    renders = os.path.join(g, "renders")
    cuda_build.reset_launch_counts()
    rc_r, _, render_s = cli_main([
        "render", "--ply", os.path.join(out, "scene.ply"), "--trajectory",
        os.path.join(out, "trajectory.npy"), "--output_path", renders,
        "--width", str(intr.width), "--height", str(intr.height), "--fx",
        repr(intr.fx), "--fy", repr(intr.fy), "--stride", "6"])
    render_launches = counted("render", ("composite_fwd",))
    names = sorted(os.listdir(renders))
    t = time.perf_counter()  # again, warm: the PLY read and the renders
    render_ply_sequence(os.path.join(out, "scene.ply"), traj,
                        os.path.join(g, "renders_warm"), intr.width,
                        intr.height, intr.fx, intr.fy, stride=6)
    warm_s = time.perf_counter() - t
    t = time.perf_counter()
    render_ply_sequence(os.path.join(out, "scene.ply"), traj[[18]],
                        os.path.join(g, "cpu_render"), intr.width,
                        intr.height, intr.fx, intr.fy, device="cpu")
    cpu_render_s = time.perf_counter() - t
    card_img = np.asarray(Image.open(os.path.join(renders, "000018.png")))
    cpu_img = np.asarray(Image.open(os.path.join(g, "cpu_render",
                                                 "000000.png")))
    agree = u8_agreement(card_img, cpu_img)
    rc_e, printed_e, eval_s = cli_main([
        "eval", "--renders", renders, "--gt", renders, "--output_json",
        os.path.join(g, "eval.json")])
    with open(os.path.join(g, "eval.json")) as f:
        ev = json.load(f)["mean"]
    print(json.dumps({
        "path": "G", "step": "render, eval", "card": card,
        "frames_rendered": names, "render_s": render_s,
        "render_s_per_frame": render_s / max(len(names), 1),
        "render_warm_s_per_frame": warm_s / max(len(names), 1),
        "frame_18_vs_cpu_plain": agree, "cpu_render_s": cpu_render_s,
        "eval_self": ev, "eval_s": eval_s,
        "ply_rows": len(load_ply(os.path.join(out, "scene.ply"))["xyz"]),
        "launches": render_launches}), flush=True)
    if rc_r != 0 or names != [f"{i:06d}.png" for i in range(0, FRAMES, 6)]:
        problems.append(f"path G: render exited {rc_r} and wrote {names}")
    if render_launches["composite_fwd"] != len(names):
        problems.append(f"path G: render launched composite_fwd "
                        f"{render_launches['composite_fwd']} times for "
                        f"{len(names)} frames")
    if not u8_within(agree):
        problems.append(f"path G: the card's render of frame 18 differs "
                        f"from the CPU's: {agree}")
    if rc_e != 0 or not (ev["psnr"] > 60 and ev["ssim"] > 0.999):
        problems.append(f"path G: eval exited {rc_e} with {ev}")

    # ---- the network viewer ---------------------------------------------
    served = []
    make = network_gui.make_map_render_fn

    def recording(params, live, sh_degree, bg=None):
        fn = make(params, live, sh_degree, bg)

        def render(*a):
            served.append(({k: v.to("cpu", copy=True)
                            for k, v in params.items()},
                           live.to("cpu", copy=True), sh_degree, bg, a))
            return fn(*a)

        return render

    w2c = np.linalg.inv(res.poses[4]).astype(np.float32)
    view = w2c.T.copy()  # the viewer's row-vector, y/z-flipped convention
    view[:, 1] *= -1.0
    view[:, 2] *= -1.0
    w, h = intr.width, intr.height
    request = {
        "resolution_x": w, "resolution_y": h, "train": True,
        "fov_y": intr.fovy, "fov_x": intr.fovx, "z_near": 0.01,
        "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": 1.0,
        "view_matrix": [float(v) for v in view.reshape(-1)],
        "view_projection_matrix": [float(v) for v in np.eye(4).reshape(-1)]}
    gui = network_gui.NetworkGUI(port=0, verify=data)
    got = {}

    def client():
        def recv(c, n):
            b = b""
            while len(b) < n:
                part = c.recv(n - len(b))
                if not part:
                    raise ConnectionError("the server closed")
                b += part
            return b

        with socket.create_connection(("127.0.0.1", gui.port),
                                      timeout=120) as c:
            raw = json.dumps(request).encode()
            c.sendall(len(raw).to_bytes(4, "little") + raw)
            got["image"] = recv(c, w * h * 3)
            got["verify"] = recv(c, int.from_bytes(recv(c, 4), "little"))

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    network_gui.make_map_render_fn = recording
    cuda_build.reset_launch_counts()
    t = time.perf_counter()
    try:
        FusedEngine(ReplicaSequence(data, intr=intr, max_frames=8), cfg,
                    seed=0, device="cuda").run(eval_render=False,
                                               net_gui=gui)
    finally:
        network_gui.make_map_render_fn = make
        gui.close()
        thread.join(timeout=120)
    viewer_s = time.perf_counter() - t
    viewer_launches = counted("viewer", ("nn1", "knn", "composite_fwd",
                                         "composite_bwd"))
    agree_v = None
    if len(served) == 1 and "image" in got:
        params, live, sh_degree, bg, args = served[0]
        want = make(params, live, sh_degree, bg)(*args)
        agree_v = u8_agreement(np.frombuffer(got["image"], np.uint8)
                               .reshape(h, w, 3), want)
    print(json.dumps({
        "path": "G", "step": "network viewer", "card": card, "frames": 8,
        "requests_served": len(served), "request": [w, h],
        "canvas": [-(-w // 64) * 64, -(-h // 64) * 64],
        "splats_in_served_map": int(served[0][1].sum()) if served else None,
        "served_vs_cpu_plain": agree_v, "seconds": viewer_s,
        "launches": viewer_launches}), flush=True)
    if thread.is_alive() or got.get("verify") != data.encode():
        problems.append("path G: the viewer's client got no answer")
    if agree_v is None or not u8_within(agree_v):
        problems.append(f"path G: {len(served)} requests served; the served "
                        f"image against the CPU's: {agree_v}")
    return total


# ---- path H: multi-device mapping ---------------------------------------

# path H's tolerances: H1 (world size 1) against path C, the same function
# without capacity buckets (float32 sums over another visible cap and
# target slice), and H2's dp against fsdp (two keyframes a mapping
# iteration, float32 sums of two ranks' gradients); the batched steps
# against the plain single-process reference take tests/test_parallel.py's
# (loss rtol 1e-5, params and Adam m rtol 2e-4)
TOL_H_ATE_M = 1e-5
TOL_H1_PSNR_DB = 1e-3
TOL_H2_PSNR_DB = 1e-2
H2_WORLD = 2
H2_JOIN_S = 300  # each H2 rank's rendezvous and its process's join


def mesh_draws(pairs, world: int, kc: int) -> list:
    """Recorded draws laid out for a mesh step of `world` ranks: each
    mapping iteration's draw is followed by the `world` draws of its batch,
    the first of which the iteration's pick overwrites; those repeat the
    iteration's draw.  The reservoir's victims (maxval kc, the keyframe
    store's size; path C never holds as many keyframes) take no batch."""
    out = []
    for m, v in pairs:
        out.append([m, v])
        if m != kc:
            out += [[m, v]] * world
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_cfg(cfg, mode: str):
    return cfg.replace(engine=dataclasses.replace(cfg.engine,
                                                  parallel_mode=mode))


def close_within(a, b, rtol: float, atol: float) -> float:
    """The largest |a - b| - (atol + rtol |b|) (numpy assert_allclose's
    test): <= 0 where a is within the tolerance of b."""
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def batched_step_checks(mesh, cfg, state, problems, tag: str) -> dict:
    """One opt_step_batched in dp and in fsdp and one make_parallel_opt_step
    on a run's final whole map (keyframes kf_count-1, kf_count-2, ... one a
    rank) against the plain single-process batched step on the card (every
    keyframe rendered here, the mean loss, one Adam step); the bytes of
    each step's collectives; ms per mapping iteration (host clock, 10
    synced iterations) and in each kind of collective (5 more, each
    collective timed alone, summed over its calls in an iteration)."""
    import torch

    from gs_icp_slam_torch.models import adam_step, map_lr_tree, map_params
    from gs_icp_slam_torch.parallel import (make_parallel_opt_step,
                                            shard_map_state)
    from gs_icp_slam_torch.parallel.mapping import gather_params
    from gs_icp_slam_torch.slam.fused import make_mapping_primitives

    W = mesh.size
    idxs = [(state.kf_count - 1 - r) % state.kf_count for r in range(W)]
    batch = (state.kf_w2c[idxs], state.kf_rgb[idxs], state.kf_depth[idxs])
    params, adam, live = map_params(state.gmap), state.adam, state.gmap.live
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    capacity = live.shape[0]

    # the plain reference: both keyframes in this process
    prim_1 = make_mapping_primitives(cfg, mesh.device)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss_ref = torch.stack([prim_1.opt_loss(leaves, live, *(b[i] for b in
                                                            batch))[0]
                            for i in range(W)]).mean()
    grads = torch.autograd.grad(loss_ref, list(leaves.values()))
    p_ref, a_ref = adam_step(params, dict(zip(params, grads)), adam,
                             map_lr_tree(cfg.opt), live, b1=cfg.opt.adam_b1,
                             b2=cfg.opt.adam_b2, eps=cfg.opt.adam_eps)
    shards = shard_map_state(mesh, params, adam, live)
    out = {}
    for mode in ("dp", "fsdp", "standalone"):
        if mode == "standalone":
            fn = make_parallel_opt_step(mesh, mesh_cfg(cfg, "fsdp")).step
        else:
            fn = make_mapping_primitives(mesh_cfg(cfg, mode), mesh.device,
                                         mesh).opt_step_batched
        args = ((params, adam, live) if mode == "dp" else shards) + batch
        mesh.audit = []
        got = fn(*args)
        audit, mesh.audit = mesh.audit, None
        p, a, loss = got[:3]
        if mode != "dp":
            p, _ = gather_params(mesh, p, shards[2])
            m, _ = gather_params(mesh, a.m, shards[2])
        else:
            m = a.m
        worst = dict(
            loss=close_within(loss.reshape(1), loss_ref.detach().reshape(1),
                              1e-5, 1e-6),
            params=max(close_within(p[k], p_ref[k], 2e-4, 1e-6)
                       for k in p if p[k].numel()),
            adam_m=max(close_within(m[k], a_ref.m[k], 2e-4, 1e-7)
                       for k in m if m[k].numel()))
        max_abs = dict(
            loss=float((loss - loss_ref.detach()).abs()),
            params=max(float((p[k] - p_ref[k]).abs().max()) for k in p
                       if p[k].numel()),
            adam_m=max(float((m[k] - a_ref.m[k]).abs().max()) for k in m
                       if m[k].numel()))
        for key, v in worst.items():
            if not v <= 0.0:
                problems.append(f"{tag} {mode} step: {key} outside the "
                                f"tolerance of the plain batched step by {v}")
        ops = {}
        for op, n, b in audit:
            ops.setdefault(op, []).append((n, b))
        arrays = {op: sum(b for n, b in v if n > 4) for op, v in ops.items()}
        if mode == "dp":
            ok = (set(ops) == {"all_reduce"}
                  and arrays["all_reduce"] == param_bytes)
        else:
            ok = (sum(b for _, b in ops.get("all_gather", []))
                  == param_bytes + capacity
                  and sum(b for _, b in ops.get("reduce_scatter", []))
                  == param_bytes // W
                  and arrays.get("all_reduce", 0) == 0)
        if not ok:
            problems.append(f"{tag} {mode} step: collective bytes {ops} "
                            f"(parameter bytes {param_bytes}, capacity "
                            f"{capacity}, world {W})")
        # ms per mapping iteration, then per collective
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        iter_ms = (time.perf_counter() - t0) / 10 * 1e3
        mesh.timings = {}
        for _ in range(5):
            fn(*args)
        timings, mesh.timings = mesh.timings, None
        out[mode] = dict(
            worst_vs_tolerance=worst, max_abs_diff=max_abs,
            ms_per_mapping_iteration=iter_ms,
            collective_ms_per_iteration={op: sum(v) / 5
                                         for op, v in timings.items()},
            collectives_per_iteration={op: len(v) for op, v in ops.items()},
            collective_bytes_per_iteration={
                op: sum(b for _, b in v) for op, v in ops.items()},
            audit_held=ok)
    out["param_bytes"] = param_bytes
    return out


def path_h1(seq, cfg_c, res_c, card, cuda_build, problems) -> dict:
    """Path H1: FusedEngine on a world-1 mesh over NCCL in this process
    (parallel.init_distributed, global_mesh), in dp ("auto" picks it) and
    fsdp, on path C's scenario and draws, then one refine call each; held
    to each other bit for bit and to path C's run.  Returns the kernels'
    launches in the two runs."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gs_icp_slam_torch.parallel import global_mesh, init_distributed
    from gs_icp_slam_torch.parallel.sharded import gather_state
    from gs_icp_slam_torch.slam import FusedEngine, RecordedDraws

    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=120)
    try:
        mesh = global_mesh()
        kc = cfg_c.engine.keyframe_capacity
        cuda_build.reset_launch_counts()
        runs = {}
        for mode in ("auto", "fsdp"):
            draws = RecordedDraws(mesh_draws(DRAWS_C + REFINE_DRAWS_C, 1, kc))
            eng = FusedEngine(seq, mesh_cfg(cfg_c, mode), mesh=mesh,
                              draws=draws)
            res = eng.run(eval_render=True)
            refined = eng.fused.refine(eng.state)
            runs[mode] = (eng, res, gather_state(refined, mesh, eng.mode))
        torch.cuda.synchronize()
        launches = launch_counts(cuda_build)
        (e_dp, r_dp, s_dp), (e_fs, r_fs, s_fs) = runs["auto"], runs["fsdp"]
        same = (np.array_equal(r_dp.poses, r_fs.poses)
                and r_dp.psnr == r_fs.psnr
                and all(torch.equal(getattr(s_dp.gmap, f),
                                    getattr(s_fs.gmap, f))
                        for f in s_dp.gmap._fields if f != "n"))
        steps = batched_step_checks(mesh, mesh_cfg(cfg_c, "dp"), s_dp,
                                    problems, "H1")
    finally:
        dist.destroy_process_group()
    if e_dp.mode != "dp" or e_fs.mode != "fsdp":
        problems.append(f"H1: modes {e_dp.mode}, {e_fs.mode}")
    if not same:
        problems.append("H1: dp and fsdp differ (poses, PSNR or the map "
                        "after the refine)")
    for mode, (eng, res, _) in runs.items():
        if not abs(res.ate_rmse - res_c.ate_rmse) <= TOL_H_ATE_M:
            problems.append(f"H1 {mode}: ATE {res.ate_rmse} vs path C "
                            f"{res_c.ate_rmse}")
        if not abs(res.ate_rmse - REF_C["ate_m"]) <= TOL_ATE_M:
            problems.append(f"H1 {mode}: ATE {res.ate_rmse} vs the JAX "
                            f"reference {REF_C['ate_m']}")
        for key in ("num_gaussians", "kf_total", "kf_stored"):
            if getattr(res, key) != getattr(res_c, key):
                problems.append(f"H1 {mode}: {key} {getattr(res, key)} vs "
                                f"path C {getattr(res_c, key)}")
        if not abs(res.psnr - res_c.psnr) <= TOL_H1_PSNR_DB:
            problems.append(f"H1 {mode}: PSNR {res.psnr} vs path C "
                            f"{res_c.psnr}")
        if res.vis_cap_dropped or res.tile_cap_dropped:
            problems.append(f"H1 {mode}: cap drops {res.vis_cap_dropped}, "
                            f"{res.tile_cap_dropped}")
    check_launched("H1", launches, ("nn1", "knn", "composite_fwd",
                                    "composite_bwd"), problems)
    print(json.dumps({
        "path": "H1", "entry": "FusedEngine(mesh=global_mesh()), world 1",
        "card": card, "backend": mesh.backend,
        "host_staged_collectives": [],
        "modes": {e.mode: dict(fps=r.fps, ate_m=r.ate_rmse, psnr_mean=r.psnr,
                               num_gaussians=r.num_gaussians,
                               kf_total=r.kf_total, kf_count=r.kf_stored,
                               vis_cap_dropped=r.vis_cap_dropped,
                               tile_cap_dropped=r.tile_cap_dropped)
                  for e, r, _ in runs.values()},
        "dp_equals_fsdp_bit_for_bit": same,
        "poses_bit_equal_to_path_c": bool(np.array_equal(r_dp.poses,
                                                         res_c.poses)),
        "psnr_equal_to_path_c": r_dp.psnr == res_c.psnr,
        "ate_minus_path_c_m": r_dp.ate_rmse - res_c.ate_rmse,
        "path_c_fps": res_c.fps, "steps": steps, "launches": launches}),
        flush=True)
    return launches


def h2_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of path H2: a gloo group over the one card; FusedEngine
    in dp and in fsdp on path C's scenario with TorchDraws(0) (the same on
    every rank), then batched_step_checks on the dp run's map; writes
    out_dir/h2-<rank>.json and .npz."""
    import datetime
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from gs_icp_slam_torch import cuda_build
    from gs_icp_slam_torch.config import synthetic_config
    from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
    from gs_icp_slam_torch.parallel import make_mesh
    from gs_icp_slam_torch.parallel.sharded import gather_state
    from gs_icp_slam_torch.slam import FusedEngine, TorchDraws

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=H2_JOIN_S))
    try:
        mesh = make_mesh("cuda:0")
        seq = InMemorySequence(open_dataset("synthetic", width=WIDTH,
                                            height=HEIGHT, num_frames=FRAMES))
        _, cfg_b = path_configs(seq, synthetic_config)
        cfg = cfg_b.replace(engine=dataclasses.replace(cfg_b.engine,
                                                       fps_cap=None))
        problems, info, arrays, wholes = [], {}, {}, {}
        cuda_build.reset_launch_counts()
        for mode in ("dp", "fsdp"):
            eng = FusedEngine(seq, mesh_cfg(cfg, mode), mesh=mesh,
                              draws=TorchDraws(0))
            res = eng.run(eval_render=True)
            st = gather_state(eng.state, mesh, eng.mode)
            wholes[mode] = st
            k = st.kf_count
            info[mode] = dict(
                fps=res.fps, ate_m=res.ate_rmse, psnr_mean=res.psnr,
                num_gaussians=res.num_gaussians, kf_total=res.kf_total,
                kf_count=res.kf_stored, vis_cap_dropped=res.vis_cap_dropped,
                tile_cap_dropped=res.tile_cap_dropped,
                local_rows=eng.state.gmap.capacity,
                kf_store_sha256=hashlib.sha256(
                    st.kf_rgb[:k].cpu().numpy().tobytes()
                    + st.kf_depth[:k].cpu().numpy().tobytes()).hexdigest())
            arrays[f"{mode}.poses"] = res.poses
            arrays[f"{mode}.target"] = st.target.points.cpu().numpy()
            arrays[f"{mode}.kf_w2c"] = st.kf_w2c.cpu().numpy()
        torch.cuda.synchronize()
        info["launches"] = launch_counts(cuda_build)
        info["steps"] = batched_step_checks(mesh, mesh_cfg(cfg, "dp"),
                                            wholes["dp"], problems, "H2")
        info["problems"] = problems
        info["backend"] = mesh.backend
        np.savez(f"{out_dir}/h2-{rank}.npz", **arrays)
        with open(f"{out_dir}/h2-{rank}.json", "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()


def path_h2(card, problems) -> dict:
    """Path H2: two processes on the one card over gloo, the counterpart
    of the JAX package's dryrun_multichip (h2_rank).  Every rank is joined
    under H2_JOIN_S; a rank that fails or hangs is a problem.  Holds the
    ranks' poses, target, counts and keyframe store equal bit for bit, and
    dp against fsdp.  Two processes share one card: the times say nothing
    of scaling.  Returns the kernels' launches summed over the ranks."""
    import multiprocessing
    import os
    import tempfile

    import numpy as np

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="path_h2_", dir=build)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=h2_rank, args=(r, H2_WORLD,
                                               f"{out_dir}/store", out_dir))
             for r in range(H2_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.perf_counter() + H2_JOIN_S
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * H2_WORLD:
        problems.append(f"H2: ranks {hung} hung, exit codes {codes}")
        return {}
    info = []
    arrays = []
    for r in range(H2_WORLD):
        with open(os.path.join(out_dir, f"h2-{r}.json")) as f:
            info.append(json.load(f))
        arrays.append(dict(np.load(os.path.join(out_dir, f"h2-{r}.npz"))))
        problems += info[r]["problems"]
    for mode in ("dp", "fsdp"):
        for key, a in arrays[0].items():
            if not np.array_equal(a, arrays[1][key]):
                problems.append(f"H2: {key} differs between the ranks")
        for key in ("num_gaussians", "kf_total", "kf_count", "psnr_mean",
                    "kf_store_sha256"):
            if info[0][mode][key] != info[1][mode][key]:
                problems.append(f"H2 {mode}: {key} differs between the "
                                f"ranks")
    dp, fs = info[0]["dp"], info[0]["fsdp"]
    if not abs(dp["ate_m"] - fs["ate_m"]) <= TOL_H_ATE_M:
        problems.append(f"H2: ATE dp {dp['ate_m']} vs fsdp {fs['ate_m']}")
    if not abs(dp["psnr_mean"] - fs["psnr_mean"]) <= TOL_H2_PSNR_DB:
        problems.append(f"H2: PSNR dp {dp['psnr_mean']} vs fsdp "
                        f"{fs['psnr_mean']}")
    for key in ("num_gaussians", "kf_total", "kf_count"):
        if dp[key] != fs[key]:
            problems.append(f"H2: {key} dp {dp[key]} vs fsdp {fs[key]}")
    launches = {k: sum(i["launches"][k] for i in info)
                for k in info[0]["launches"]}
    check_launched("H2", launches, ("nn1", "knn", "composite_fwd",
                                    "composite_bwd"), problems)
    print(json.dumps({
        "path": "H2", "entry": "FusedEngine(mesh=make_mesh('cuda:0')), "
        "two processes on one card", "card": card,
        "backend": info[0]["backend"], "host_staged_collectives": [],
        "wall_s": wall, "ranks": info,
        "dp_vs_fsdp": dict(ate_m=dp["ate_m"] - fs["ate_m"],
                           psnr_db=dp["psnr_mean"] - fs["psnr_mean"],
                           poses_max_abs=float(np.abs(
                               arrays[0]["dp.poses"]
                               - arrays[0]["fsdp.poses"]).max())),
        "launches": launches}), flush=True)
    return launches


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the GPU")
    try:
        from gs_icp_slam_torch import cuda_build
        from gs_icp_slam_torch.config import synthetic_config
        from gs_icp_slam_torch.datasets import InMemorySequence, open_dataset
        from gs_icp_slam_torch.models import map_params
        from gs_icp_slam_torch.ops import composite_cuda, nn_cuda
        from gs_icp_slam_torch.ops.rasterize import bin_splats
        from gs_icp_slam_torch.slam import (FusedEngine, RecordedDraws,
                                            SLAMEngine)
    except ImportError as e:
        fail(f"the gs_icp_slam_torch package is not beside this script: {e}")

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(reports)} sources compiled in {build_s:.1f} s "
          f"({', '.join(sorted(reports)) or 'cached'})", flush=True)
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---- 2. the paths ---------------------------------------------------
    phase_s = {"build": build_s}
    t_phase = time.perf_counter()
    # frames made up front: synthesizing one costs ~0.1 s on the host,
    # set-up rather than the engine's time
    seq = InMemorySequence(open_dataset("synthetic", width=WIDTH,
                                        height=HEIGHT, num_frames=FRAMES))
    cfg_a, cfg_b = path_configs(seq, synthetic_config)
    problems = []

    def run_path(name, cfg, ref, kernels_of_path):
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        eng = SLAMEngine(seq, cfg, device="cuda")
        res = eng.run(eval_render=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in cuda_build.KERNELS.values()}
        psnr_mean = float(res.psnr)
        print(json.dumps({
            "path": name, "entry": "SLAMEngine.run", "frames": FRAMES,
            "width": WIDTH, "height": HEIGHT,
            "mapping_iters_per_frame": cfg.engine.mapping_iters_per_frame,
            "opt_steps": eng.train_iter, "fps": res.fps,
            "wall_s_with_render": wall, "ate_m": res.ate_rmse,
            "num_gaussians": res.num_gaussians, "kf_total": res.kf_total,
            "psnr_mean": psnr_mean,
            "psnr_min": float(res.per_frame_psnr.min()),
            "vis_cap_dropped": res.vis_cap_dropped,
            "tile_cap_dropped": res.tile_cap_dropped, "launches": launches,
            "tile_cap_K": eng.tile_cap}), flush=True)
        for k in kernels_of_path:
            if launches[k] <= 0:
                problems.append(f"path {name}: kernel {k} was not launched")
        if not np.isfinite(res.poses).all():
            problems.append(f"path {name}: non-finite poses")
        if not abs(res.ate_rmse - ref["ate_m"]) <= TOL_ATE_M:
            problems.append(f"path {name}: ATE {res.ate_rmse} vs reference "
                            f"{ref['ate_m']}")
        for key, got in (("num_gaussians", res.num_gaussians),
                         ("kf_total", res.kf_total)):
            if got != ref[key]:
                problems.append(f"path {name}: {key} {got} vs reference "
                                f"{ref[key]}")
        if not abs(psnr_mean - ref["psnr_mean"]) <= TOL_PSNR_DB:
            problems.append(f"path {name}: PSNR {psnr_mean} vs reference "
                            f"{ref['psnr_mean']}")
        return eng, res, launches

    _, res_a, launches_a = run_path("A", cfg_a, REF_A,
                                    ("nn1", "knn", "composite_fwd"))
    eng, res, launches = run_path("B", cfg_b, REF_B,
                                  ("nn1", "knn", "composite_fwd",
                                   "composite_bwd"))
    if launches["composite_bwd"] != eng.train_iter:
        problems.append(f"composite_bwd launched {launches['composite_bwd']} "
                        f"times for {eng.train_iter} opt steps")
    launches_b = launches

    # ---- path C: FusedEngine.run, bench.py's scenario ------------------
    cfg_c = cfg_b.replace(engine=dataclasses.replace(cfg_b.engine,
                                                     fps_cap=None))
    eng_c, res_c, launches_c, syncs, nn_args_c = run_path_c(
        seq, cfg_c, FusedEngine, RecordedDraws, cuda_build, problems)
    phase_s["A, B, C (with evaluate)"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---- path D: the dense compositors' entry points ------------------
    dense = {}
    cuda_build.reset_launch_counts()
    for key, (T_, ntx_, K_, dyn) in DENSE_GEOMETRIES.items():
        counts_np, attrs_np, g_t = dense_case(key)
        counts_t = torch.as_tensor(counts_np, device="cuda")
        attrs_t = torch.as_tensor(attrs_np, device="cuda")
        g_t = g_t.to("cuda")
        a_leaf = attrs_t.clone().requires_grad_(True)
        if dyn:
            out_t = composite_cuda.make_composite_dyn(
                T_, ntx_, DENSE_TILE, K_)(counts_t, a_leaf)
        else:
            out_t = composite_cuda.make_composite(T_, ntx_, DENSE_TILE,
                                                  K_)(a_leaf)
        (out_t * g_t).sum().backward()
        torch.cuda.synchronize()
        if not (torch.isfinite(out_t).all() and torch.isfinite(a_leaf.grad)
                .all()):
            problems.append(f"path D {key}: non-finite output or gradient")
        dense[key] = dict(T=T_, ntx=ntx_, K=K_, dyn=dyn, counts=counts_t,
                          attrs=attrs_t, g=g_t, attrs_np=attrs_np,
                          counts_np=counts_np, out=out_t.detach(),
                          grad=a_leaf.grad)
    launches_d = {k.name: k.launches for k in cuda_build.KERNELS.values()}
    print(json.dumps({"path": "D", "entry": "make_composite, "
                      "make_composite_dyn", "geometries": {
                          k: dict(tiles=v["T"], ntx=v["ntx"], tile=DENSE_TILE,
                                  K=v["K"], counts=v["dyn"])
                          for k, v in dense.items()},
                      "launches": launches_d}), flush=True)
    for k in DENSE_KERNELS:
        if launches_d[k] <= 0:
            problems.append(f"path D: kernel {k} was not launched")
    phase_s["D"] = time.perf_counter() - t_phase

    # ---- map maintenance on path C's map; paths E, F1, F2 (the port
    # bench at stages 0, 1, 2); the stress tier ----------------------------
    t_phase = time.perf_counter()
    maintenance_phase(eng_c, problems)
    phase_s["maintenance"] = time.perf_counter() - t_phase
    by_path = {}
    for name in BENCH_PATHS:
        t_phase = time.perf_counter()
        by_path[name] = bench_path(name, card, cuda_build,
                                   problems)["launches"]
        phase_s[name] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    stress = stress_phase(cuda_build, problems)
    phase_s["stress"] = time.perf_counter() - t_phase
    by_path["stress"] = {k: sum(r["launches"][k] for r in stress.values())
                         for k in launches_d}
    t_phase = time.perf_counter()
    by_path["G"] = path_g(seq, card, cuda_build, problems)
    phase_s["G"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    by_path["H1"] = path_h1(seq, cfg_c, res_c, card, cuda_build, problems)
    phase_s["H1"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    by_path["H2"] = path_h2(card, problems) or {k: 0 for k in launches_d}
    phase_s["H2"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # ---- 3. kernels against their plain versions ------------------------
    dev = torch.device("cuda")
    kernels = []
    gen = torch.Generator(device="cpu").manual_seed(0)

    # K2 at tracking shapes: 8,192 queries x 65,536 target slots, ~30% of
    # them invalid (the Gauss-Newton inner loop's call)
    Q, Tp = 8192, 1 << 16
    q = (torch.rand((Q, 3), generator=gen) * 4 - 2).to(dev)
    rT = (torch.rand((3, Tp), generator=gen) * 4 - 2).to(dev).contiguous()
    valid = (torch.rand(Tp, generator=gen) > 0.3).to(dev)
    bias = torch.where(valid, 0.0, 3.4e38).float()[None].contiguous()
    i1, d1 = nn_cuda.nn_search_pre(q, rT, bias)
    i0, d0 = nn_cuda.nn1_plain(q, rT, bias)
    torch.cuda.synchronize()
    err = float((d1 - d0).abs().max())
    n_idx = int((i1 != i0).sum())
    if n_idx or err > 0.0:
        problems.append(f"nn1: {n_idx} indices differ, max |dsqd| {err} "
                        "(tolerance: exact)")
    rv = rT.T[valid].contiguous()
    nv = int(valid.sum())
    b, by = bound(Q * nv * 9.0, Q * 12 + Tp * 16 + Q * 8)
    # what the search did, counted by the kernel in one more call
    ic, dc, st_cube = nn_cuda.nn1_search_counts(q, rT, bias)
    if not (torch.equal(ic, i0) and torch.equal(dc, d0)):
        problems.append("nn1: the counting call differs from nn1_plain")

    # K2 on the tracking target: the arguments of path C's last
    # Gauss-Newton step (query order: 8x8 pixel blocks; target order:
    # Morton), through the same entry point
    tq, trT, tbias, tro, tqo = nn_args_c
    ti1, td1 = nn_cuda.nn_search_pre(*nn_args_c)
    ti0, td0 = nn_cuda.nn1_plain(tq, trT, tbias)
    torch.cuda.synchronize()
    t_err = float((td1 - td0).abs().max())
    t_idx = int((ti1 != ti0).sum())
    if t_idx or t_err > 0.0:
        problems.append(f"nn1 on the tracking target: {t_idx} indices "
                        f"differ, max |dsqd| {t_err} (tolerance: exact)")
    ic, dc, st_trk = nn_cuda.nn1_search_counts(*nn_args_c)
    if not (torch.equal(ic, ti0) and torch.equal(dc, td0)):
        problems.append("nn1 on the tracking target: the counting call "
                        "differs from nn1_plain")
    tQ, tTp, tL = tq.shape[0], trT.shape[1], tro.shape[0]
    t_nv = int((tbias == 0).sum())
    # the pairs the search needs on this data when it visits the chunks
    # nearest first, one at a time (the plain model; the kernel's warps
    # visit in parallel and compare more), 9 operations each; the
    # queries, both orders, the target's points and bias read once, the
    # outputs written
    _, _, st_seq = nn_cuda.nn1_chunked_plain(*nn_args_c)
    tb, tby = bound(st_seq["pairs"] * 9.0,
                    tQ * 16 + tL * 4 + tTp * 16 + tQ * 8)
    tracking = dict(
        queries=tQ, target_slots=tTp, valid_refs=t_nv, max_abs_err=t_err,
        ms=time_ms(lambda: nn_cuda.nn_search_pre(*nn_args_c)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_plain(tq, trT, tbias), reps=3,
                         warmup=1),
        bound_ms=tb, bound_by=tby,
        library_ms=time_ms(lambda: torch.cdist(
            tq, trT.T[tbias[0] == 0]).min(dim=1), reps=5),
        chunks=st_trk["chunks"], groups=st_trk["groups"],
        chunk_visits=st_trk["visits"], chunks_culled=st_trk["culled"],
        pairs_compared=st_trk["pairs"],
        chunk_visits_one_at_a_time=st_seq["visits"],
        pairs_one_at_a_time=st_seq["pairs"])
    print(json.dumps({"phase": "nn1 on the tracking target", **tracking}),
          flush=True)
    kernels.append(dict(
        name="nn1", route="cuda", source="gs_icp_slam_torch/csrc/nn1.cu",
        replaces="gs_icp_slam_tpu/ops/nn_pallas.py:32",
        launches=launches_c["nn1"], launches_path_a=launches_a["nn1"],
        launches_path_b=launches_b["nn1"],
        max_abs_err=err,
        ms=time_ms(lambda: nn_cuda.nn_search_pre(q, rT, bias)),
        plain_ms=time_ms(lambda: nn_cuda.nn1_plain(q, rT, bias), reps=3,
                         warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.cdist(q, rv).min(dim=1), reps=5),
        chunks_culled=st_cube["culled"], chunk_visits=st_cube["visits"],
        tracking_target=tracking))

    # K3 at the frame-0 target's shapes: the first frame's downsampled
    # cloud, k = 20 (covariances) and k = 4 (mean_sq_dist_3nn); and a
    # random cube of as many points, 30% of them invalid, where little
    # culls (drawn as scripts/torch_knn_times.py draws it, so that the
    # script's times of two trees compare with this row)
    from gs_icp_slam_torch.utils.pointcloud import (downsample_pointcloud,
                                                    make_downsample_filter)
    cfg = cfg_b
    intr = cfg.intr
    filt = make_downsample_filter(intr.width, intr.height, intr.fx, intr.fy,
                                  intr.cx, intr.cy, cfg.downsample_rate)
    fr = seq[0]
    pc = downsample_pointcloud(filt, torch.from_numpy(fr.depth).to(dev),
                               torch.from_numpy(fr.rgb).to(dev),
                               intr.depth_scale, intr.depth_trunc)
    pts, trk = pc["points"].contiguous(), pc["trackable"].contiguous()
    R = pts.shape[0]
    gen_k3 = torch.Generator(device="cpu").manual_seed(5)
    cube = (torch.rand((R, 3), generator=gen_k3) * 4 - 2).to(dev)
    cube_valid = (torch.rand(R, generator=gen_k3) > 0.3).to(dev)
    knn = {}
    for case, k, cloud, ok in (("frame0", 20, pts, trk),
                               ("frame0", 4, pts, trk),
                               ("frame0", 40, pts, trk),
                               ("cube", 20, cube, cube_valid)):
        i1, d1 = nn_cuda.knn_search_kernel(cloud, cloud, ok, k)
        i0, d0 = nn_cuda.knn_plain(cloud, cloud, ok, k)
        ic, dc, st_k = nn_cuda.knn_search_counts(cloud, cloud, ok, k)
        torch.cuda.synchronize()
        have = d0 < 1e37
        err = float((d1 - d0).abs().max())
        n_idx = int((i1 != i0)[have].sum())
        if n_idx or err > 0.0:
            problems.append(f"knn {case} k={k}: {n_idx} indices differ, max "
                            f"|dsqd| {err} (tolerance: exact)")
        if not (torch.equal(ic[have], i0[have]) and torch.equal(dc, d0)):
            problems.append(f"knn {case} k={k}: the counting call differs "
                            "from knn_plain")
        nv = int(ok.sum())
        # two bases: the pairs the chunked search compares when it takes
        # each group's chunks one at a time, nearest first (the plain
        # model), at 10 operations, the row's bound; and every (query,
        # valid reference) pair, the work of the old scan.  Points,
        # validity, the outputs
        nbytes = R * 12 * 2 + R + R * k * 8
        b_all, by_all = bound(R * nv * 10.0, nbytes)
        _, _, st_seq = nn_cuda.knn_chunked_plain(
            cloud, cloud, ok, k, *nn_cuda.knn_orders(cloud, cloud, ok))
        b_seq, by_seq = bound(st_seq["pairs"] * 10.0, nbytes)
        okv = cloud[ok]
        knn[(case, k)] = dict(
            queries=R, valid_refs=nv, k=k, max_abs_err=err,
            ms=time_ms(lambda: nn_cuda.knn_search_kernel(cloud, cloud, ok,
                                                         k)),
            plain_ms=time_ms(lambda: nn_cuda.knn_plain(cloud, cloud, ok, k),
                             reps=3, warmup=1),
            bound_ms=b_seq, bound_by=by_seq,
            library_ms=time_ms(lambda: torch.cdist(cloud, okv).topk(
                k, dim=1, largest=False), reps=5),
            bound_ms_all_pairs=b_all, bound_by_all_pairs=by_all,
            chunks=st_k["chunks"], groups=st_k["groups"],
            chunk_visits=st_k["visits"], chunks_culled=st_k["culled"],
            pairs_compared=st_k["pairs"],
            chunk_visits_one_at_a_time=st_seq["visits"],
            pairs_one_at_a_time=st_seq["pairs"])
        print(json.dumps({"phase": f"knn {case} k={k}", **knn[(case, k)]}),
              flush=True)
    # the main path's call (frame 0, k = 20) is the row; k = 4
    # (mean_sq_dist_3nn), k = 40 (two passes) and the random cube ride
    # along under their keys
    kernels.append(dict(
        name="knn", route="cuda", source="gs_icp_slam_torch/csrc/knn.cu",
        replaces="gs_icp_slam_tpu/ops/nn_pallas.py:113",
        launches=launches_c["knn"], launches_path_a=launches_a["knn"],
        launches_path_b=launches_b["knn"], **knn[("frame0", 20)],
        k4=knn[("frame0", 4)], k40=knn[("frame0", 40)],
        random_cube=knn[("cube", 20)]))

    # K2 and K3 above 2^20 references, nested under their rows
    big = big_reference_phase(nn_cuda, problems)
    for row in kernels:
        if row["name"] in big:
            row["above_2_20_refs"] = big[row["name"]]

    # K1-fwd on the compositor inputs of a real 1200x680 view of path B's
    # mapped map (frame 18's estimated pose)
    m, rc = eng.gmap, cfg.render
    w2c = torch.linalg.inv(torch.as_tensor(res.poses[18], dtype=torch.float32,
                                           device=dev))
    sh = torch.cat([m.f_dc[:, None, :], m.f_rest], dim=1)
    bn = bin_splats(m.xyz, m.rotation, torch.exp(m.log_scaling),
                    torch.sigmoid(m.opacity_logit[:, 0]), sh, w2c, m.live,
                    intr.fx, intr.fy, (intr.width - 1) / 2.0,
                    (intr.height - 1) / 2.0, sh_degree=cfg.map.sh_degree,
                    width=intr.width, height=intr.height, tile=rc.tile_size,
                    visible_cap=rc.visible_capacity, tile_span=rc.tile_span,
                    tile_cap=eng.tile_cap)
    ntx = -(-intr.width // rc.tile_size)
    cargs = (bn.counts, bn.starts, bn.pair_slot, bn.attr_v, ntx, rc.tile_size)
    o1, nc1 = composite_cuda.composite_fwd(*cargs)
    o0, nc0 = composite_cuda.composite_fwd_plain(*cargs)
    oc, ncc, st_f = composite_cuda.composite_fwd_counts(*cargs)
    torch.cuda.synchronize()
    err = float((o1 - o0).abs().max())
    if not (torch.equal(nc1, nc0) and torch.equal(o1, o0)):
        problems.append(f"composite_fwd: n_contrib differs at "
                        f"{int((nc1 != nc0).sum())} pixels, max |dout| {err} "
                        "(tolerance: exact)")
    if not (torch.equal(oc, o0) and torch.equal(ncc, nc0)):
        problems.append("composite_fwd: the counting call differs from "
                        "composite_fwd_plain")
    # the plain model of the kernel's cull: the pairs examined, those that
    # blend or stop, and that no culled pair would have (lost)
    _, _, model = composite_cuda.composite_fwd_cull_plain(*cargs)
    examined, gated = model["examined"], model["gated"]
    if st_f["evaluated"] + st_f["culled"] != examined or model["lost"]:
        problems.append(f"composite_fwd: the kernel evaluated "
                        f"{st_f['evaluated']} and culled {st_f['culled']} "
                        f"pairs, the plain version examines {examined}; "
                        f"the plain cull loses {model['lost']} pairs")
    T = bn.counts.shape[0]
    P = rc.tile_size ** 2
    nbytes = (T * 8 + int(bn.counts.sum()) * 4 + bn.attr_v.numel() * 4
              + T * 8 * P * 4)
    # two bases: the pairs that blend or stop, the only ones whose work
    # cannot be skipped, the row's bound; and every pair the plain version
    # examines, the work of the old design
    kernels.append(dict(
        name="composite_fwd", route="cuda",
        source="gs_icp_slam_torch/csrc/composite_fwd.cu",
        replaces="gs_icp_slam_tpu/ops/composite_pallas.py:485",
        launches=launches_c["composite_fwd"],
        launches_path_a=launches_a["composite_fwd"],
        launches_path_b=launches_b["composite_fwd"], max_abs_err=err,
        ms=time_ms(lambda: composite_cuda.composite_fwd(*cargs)),
        plain_ms=time_ms(lambda: composite_cuda.composite_fwd_plain(*cargs),
                         reps=2, warmup=1),
        library_ms=None, **fwd_bounds(examined, gated, nbytes),
        pairs_examined=examined, pairs_gated=gated,
        pairs_evaluated=st_f["evaluated"], pairs_culled=st_f["culled"],
        pairs_culled_plain_model=model["culled"],
        splats_visible=int(bn.stats[0]), max_count=int(bn.counts.max())))

    # K1-bwd on the compositor inputs and the real gradient of one opt step
    # of path B's map: the newest keyframe's view, the mapping loss's g
    # captured where the autograd Function hands it to the kernel
    captured = {}
    launch_bwd = composite_cuda.composite_bwd

    def record(*a):
        captured["args"] = a
        return launch_bwd(*a)

    kf = eng.kf_count - 1
    composite_cuda.composite_bwd = record
    try:
        eng.prim.opt_step(map_params(m), eng.adam, m.live,
                          eng._to_device(eng.kf_w2c[kf]),
                          eng._to_device(eng.kf_rgb[kf]),
                          eng._to_device(eng.kf_depth[kf]))
    finally:
        composite_cuda.composite_bwd = launch_bwd
    bargs = tuple(a.detach() if torch.is_tensor(a) else a
                  for a in captured["args"])
    pargs = bargs[:9]  # the plain version takes no splat -> pair-row map
    d1 = composite_cuda.composite_bwd(*bargs)
    d2 = composite_cuda.composite_bwd(*bargs)
    d0 = composite_cuda.composite_bwd_plain(*pargs)
    torch.cuda.synchronize()
    row_scale = d0[:10].abs().amax(1).clamp(min=1e-30)
    row_err = ((d1[:10] - d0[:10]).abs().amax(1) / row_scale).tolist()
    if not max(row_err) <= TOL_BWD_ROW:
        problems.append(f"composite_bwd: row errors {row_err} > "
                        f"{TOL_BWD_ROW} of the row's largest |gradient|")
    if not torch.equal(d1, d2):
        problems.append("composite_bwd: two launches on the same inputs "
                        "gave different bits")
    walked, blended = composite_cuda.composite_bwd_work(*pargs)
    counts_b, _, _, attr_b, out_b, nc_b = bargs[:6]
    rows_b = bargs[9]
    T, P = counts_b.shape[0], out_b.shape[2]
    cells = int(torch.minimum(nc_b.amax(1), counts_b).sum())
    # the kernel writes a cell of ten sums for every (run row, tile
    # corner) and reads it back through the splat -> pair-row map
    tile_b = bargs[8]
    nsub = (-(-tile_b // min(tile_b, composite_cuda.BWD_SIDE))) ** 2
    cell_bytes = int(counts_b.sum()) * nsub * 10 * 4
    nbytes = (T * 8 + int(counts_b.sum()) * 4 + attr_b.numel() * 4
              + T * P * 4 * (1 + 1 + 5)        # t_final, n_contrib, g 0-4
              + rows_b.numel() * 4             # the splat -> pair-row map
              + 2 * cell_bytes                 # cells written and read
              + attr_b.numel() * 4)            # the gradient written
    kernels.append(dict(
        name="composite_bwd", route="cuda",
        source="gs_icp_slam_torch/csrc/composite_bwd.cu",
        replaces="gs_icp_slam_tpu/ops/composite_pallas.py:547",
        launches=launches_c["composite_bwd"],
        launches_path_a=launches_a["composite_bwd"],
        launches_path_b=launches_b["composite_bwd"],
        max_abs_err=float((d1 - d0).abs().max()),
        row_err_vs_row_max=row_err, deterministic=bool(torch.equal(d1, d2)),
        ms=time_ms(lambda: composite_cuda.composite_bwd(*bargs)),
        plain_ms=time_ms(lambda: composite_cuda.composite_bwd_plain(*pargs),
                         reps=2, warmup=1),
        library_ms=None, **bwd_bounds(walked, blended, nbytes),
        pairs_walked=walked, pairs_blended=blended, cells_walked=cells,
        bound_bytes=nbytes,
        cell_bytes=cell_bytes, run_rows=int(counts_b.sum()),
        max_n_contrib=int(nc_b.max())))

    # K1-fwd and K1-bwd at a stage-1 opt view, nested under their rows
    stage1 = stage1_k1_phase(eng_c, cfg_b, composite_cuda, problems)
    for row in kernels:
        if row["name"] in stage1:
            row["stage1_view"] = stage1[row["name"]]

    # K4 on a real view: path B's frame-18 view binned at 16-pixel tiles,
    # the runs packed into dense blocks of 256
    vc, va, vntx, clipped, longest = k4_view_inputs(eng, res, cfg_b,
                                                    bin_splats)
    g_v = torch.randn((va.shape[0], 8, DENSE_TILE ** 2),
                      generator=torch.Generator().manual_seed(4)).to(dev)
    g_v[:, 5:] = 0.0
    view = dict(counts=vc, attrs=va, ntx=vntx, g=g_v,
                counts_np=vc.cpu().numpy(), clipped=clipped, longest=longest)
    print(json.dumps({"phase": "K4_view", "tiles": va.shape[0],
                      "K": va.shape[2], "runs_clipped_at_K": clipped,
                      "longest_run": longest,
                      "mean_count": float(vc.float().mean())}), flush=True)
    kernels += dense_kernel_phases(dense, view, launches_d, composite_cuda,
                                   problems)
    for row in kernels:
        row["launches_by_path"] = {k: v[row["name"]]
                                   for k, v in by_path.items()}
    phase_s["kernels"] = time.perf_counter() - t_phase
    print(json.dumps({"phase_seconds": phase_s}), flush=True)

    if problems:
        for p in problems:
            print(f"FAILED: {p}", file=sys.stderr)
        raise SystemExit(1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
