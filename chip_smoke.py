#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bevy_gaussian_splatting_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py            # the whole run (a few minutes of
                                     # script time on "NVIDIA H100 80GB
                                     # HBM3, 700.00 W")
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of one
                                     # frame per size and mode and of one
                                     # training step, written to the output
                                     # directory

Phases, each of which raises on failure (nothing is caught).  Phases 3-5,
14-17 and 6 run with OBB bounds (``CloudSettings()``), then phases 3-5, 14
and 7 with AABB bounds (``CloudSettings(aabb=True)``), then phase 8, then
phases 3-5, 14, 6 and 26 with 2DGS surfels
(``CloudSettings(gaussian_mode=GAUSSIAN_2D)``), then phases 9, 20 and 21, then
phases 23-25, then phases 10-13 for 4DGS with OBB (with phase 18 after 12) and
then AABB bounds, then phases 19 and 22:

  1. build   every kernel under bevy_gaussian_splatting_tpu_torch/csrc with
             nvcc for sm_90a, one nvcc per source, all started together,
             and beside them the native host runtime
             (bevy_gaussian_splatting_tpu_torch/native/gsplat_native.cpp)
             with g++; print what ptxas reports for each kernel (registers,
             shared memory, spills), and the backward compositor's
             dynamic shared memory and resident blocks per SM in each
             mode;
  2. scene   the repo's benchmark scene: 1,000,000 gaussians from
             ``random_gaussians_3d_seeded(n, seed=0)``, positions scaled by
             (1, 1, 0.25), scales by 0.05 (bench.py), camera at (0, 0, 60);
  3. kernels each kernel against its plain PyTorch version on the scene's
             real inputs at 512x512 and 1920x1080: expansion array-equal,
             compositing within 2e-5 (2DGS 1e-4, the JAX package's 2DGS
             bar), also in its bounding-box overlay instantiation (with the
             pixels an edge closed, which must be some), the backward
             compositor within 1e-4 of each gradient
             column's largest magnitude (its cotangent taken from a real
             loss; the AABB radius column and the 2DGS surfel radius column
             exactly 0 in both); for both compositors two launches bitwise
             equal and the share of (pair, warp) visits their cull keeps,
             from the twin of the mask; the segmented reduce bit-equal
             (16 columns for 2DGS); the paths the expansion's and the
             reduce's blocks take, from their twins;
             with AABB also all four kernels at the convergence protocols'
             shapes (512 gaussians at 128x128, 192 at 48x48), timed over
             200 launches;
  4. small   ``render()`` on the card against the port's oracle (3e-5; 2DGS
             1e-4) and against the same call on the CPU (2e-5; 2DGS 1e-4),
             and the gradients of every cloud field, card against CPU (1e-4
             of the field's largest magnitude), at 128x128 and 128x120; for
             2DGS on the bench-style cloud and on the surfel grid of
             ``tools/surfel_plane.py``; then ``render()`` with the overlay.
             With OBB also each rasterize mode beside COLOR (but VELOCITY)
             and each draw mode, the STD and RAYON sorts (against the
             oracle), the gradients of the overlay's training route (card
             against CPU) and, with opacity-0 gaussians, the count of
             pixels where the oracle's boxes and the tiled path's differ;
  5. main    ``render()`` at four orbit poses at 512x512, then 1920x1080,
             with the launch counters set to 0 just before and read after;
             every frame must launch the expansion and the compositor's
             instantiation of its (mode, overlay), no other compositor
             instantiation and no backward kernel, and give a finite image
             with at least a quarter of its pixels lit.  Then the same with
             the overlay (8 frames per size), and with OBB one frame per
             size in each rasterize mode beside COLOR;
  6. train   Adam steps (``train/step.py``) on the scene as a
             ``TrainableCloud`` towards a render of the same cloud moved by
             (0.25, -0.15, 0.1): a warm-up and 10 timed steps on the bench
             objective mean((img - target)^2) and two
             ``gaussian_splatting_loss`` steps at 512x512, then a warm-up
             and 2 timed steps at 1920x1080.  Every step must launch all
             four kernels and give a finite loss and finite gradients; the
             last bench-objective loss must be below the first (2DGS: 5
             timed steps at 512x512, 2 at 1920x1080, no
             ``gaussian_splatting_loss`` steps).  With OBB then a warm-up and
             2 steps in NORMAL mode at 512x512, with the same checks;
  7. train   (AABB) the training loop's pieces on the scene: a warm-up and 5
             Adam steps at 512x512, a warm-up and 2 at 1920x1080, with
             ``accumulate_stats`` after every step, then one
             ``densify_and_prune(k_budget=N // 8)`` (scene extent from
             ``compute_aabb``), a fresh Adam and 2 more steps.  The same checks
             per step; the densify stats are printed;
  8. converge ``convergence_psnr()`` on the card at the JAX package's bench
             protocol (120 steps, 512 gaussians, 128x128; at least 15.91 dB,
             its 16.41 dB less 0.5) and at its CPU test protocol (60 steps,
             192 gaussians, 48x48; at least 17.28 dB);
  9. flavours the other cloud flavours on the 1M bench scene (OBB) through
             ``render()``, a warm-up and 5 timed frames each per size:
             ``precompute_covariance_3d`` within 1e-6 of the quaternion and
             scale render, f16 and bf16 storage within 2e-5 of the float32
             render of the rounded cloud, ``set_sh_degree(cloud, 4)``
             within 2e-6 of degree 3;
 10. kernels (4DGS) phase 3 on the JAX bench's 4DGS scene,
             ``random_gaussians_4d_seeded(1M, seed=3)`` unscaled, at time
             0.25, the cotangent from a render of the same cloud at 0.3; it
             adds the pair truncation, the expansion's search blocks and the
             reduce's blocks by windows;
 11. small   (4DGS) 2,000 gaussians: ``render()`` card against the oracle
             and the CPU at times 0.25 and 0.75 (the image must move) and
             the gradients card against CPU, each CPU bar the larger of the
             fixed one and the CPU's own spread under a one-ulp quaternion
             change (the OBB axis of a 4D splat is ill-conditioned), a frame
             with a mask decided apart at its threshold held to the oracle
             alone; the overlay, VELOCITY, and VELOCITY with the overlay
             (the pixels where oracle and tiled path differ);
 12. main    (4DGS) the pair counts at times 0.25, 0.5 and 0.75 and the
             budget of the worst, then a warm-up and 24 ``render()`` frames
             at times 0.25 + 0.01 i per size, each through the expansion
             and the compositor, then one VELOCITY and one overlay frame;
 13. train   (4DGS) a warm-up and 4 (512x512) or 2 (1920x1080) Adam steps
             towards a render of the same cloud at time 0.3, every step
             through all four kernels, finite;
 14. serve   ``InteractiveRenderer(period_floor_ms=1e9)`` at 512x512, the
             JAX bench's replay protocol (bench.py:246-300): ``render_orbit``
             at el 0.2, radius 60, a sub-threshold move (az 1e-5: no more
             pixels past 2e-3 from a fresh ``render()`` than the fresh
             frames' own change under the move gives, as near-tied depths
             swap; in OBB and AABB also within 2e-3 beyond that change at
             each pixel), the same pose again (bitwise), then 3 windows of
             24 orbit frames: one bin
             across the orbit, the bin frame through the expansion once,
             every replay frame through the mode's compositor and no
             expansion.  ``InteractiveRenderer.render`` at a host camera
             against ``render(impl="tiled")`` (2e-6, and whether bitwise);
             the replay pipeline's bin and replay calls, then the bin
             frame, replay frame and ``render()``, timed in turns; the
             device time and idle share of a replay frame (profiler);
 15. orbit keys the radix keys of an orbit camera built on the card against
             the same camera built on the CPU, on the 1M scene (counted),
             and ``render_orbit`` card against CPU on 2,000 gaussians at
             128x128, held to the JAX test's bars (mean < 1e-3, 99.5% of
             pixels within 1e-2);
 16. multi-camera ``render_multi_camera`` at the four orbit poses at
             512x512, each view bitwise its own ``render_tiled``;
 17. background a full-image [H, W, 4] background at 512x512 and 1920x1080
             (pad rows cropped) against the bare frame blended under its
             transmittance (1e-6); at 128x120 on 2,000 gaussians card
             against CPU (2e-5) and the oracle (3e-5), and the background's
             gradient card against CPU (1e-4 of its largest);
 18. serve 4D (OBB) a time sweep of ``render_orbit``: every frame one pass
             (``oneshots``), through the expansion and the compositor; a
             settled time then bins once and replays, both bitwise the
             one-pass frame;
 19. examples the port's five examples (``examples/``; the streaming and
             LOD flyby writes its frames by its environment knobs), each on
             the card, writing its PNGs into the output directory;
 20. io      (OBB) the 1M scene saved by the port's encoders as .gcloud
             (FlexBuffers and bincode2), .npz, .ply and a .glb (with a second
             65,536-row cloud moved by ``SCENE_SHIFT`` and the bench camera),
             and 65,536-row 4D .gc4d (both codecs) and .ply4d and cov3d
             .gcloud files, in a temporary directory, each loaded by
             ``load_any`` on the card: the lossless formats bitwise the source
             and their frame bitwise the in-memory frame, PLY and GLB bitwise
             the CPU's decode of the same bytes, the 1M .ply and .gcloud by
             the native decoders; save and load ms and bytes.  The native
             runtime against the numpy and FlexBuffers paths it replaced as
             the default: the 1M .ply and .gcloud and the 65,536-row .gc4d
             loaded each way in turns (medians of ``NATIVE_TURNS``), the
             .gcloud and .gc4d array-equal both ways, the PLY within 1e-5
             (the JAX package's bar between its two decoders; differing
             elements counted), the native 3D bytes those of the port's
             FlexBuffers writer, the native 4D bytes read array-equal by the
             FlexBuffers reader; ``radix_sort_pairs`` of 1M seeded pairs
             equal to a stable argsort, both timed.
             ``render_scene`` on the GLB at 512x512 and 1920x1080 bitwise its
             two ``render()`` calls chained by hand, and at 128x120 (each
             cloud cut to 65,536 rows) within 2e-5 of the CPU.  At 1M, card
             against CPU: ``points_in_mesh`` in a 12-triangle box (flips
             only at the box's faces or face diagonals, counted),
             ``interpolate_clouds`` 1e-6, ten particle steps with duplicate
             and inert behaviours 1e-5, ``_hash4`` bit-equal,
             ``apply_noise`` 1e-5 on every 64th row; each result rendered
             once;
 21. front ends (OBB) in a temporary working directory: the 1M scene
             sliced on the card into a 4x4x1 grid (rows, cells and AABBs
             bitwise the CPU's slice), saved as a streaming scene (bytes,
             ms), a ``StreamingCloudScene(background=True)`` along a camera
             path across the grid (after each update the resident ids are
             the set the manifest's AABBs give, the resident cloud is
             bitwise the CPU's concatenation of the chunk files, padded, and
             its frame is finite; load and frame ms), ``build_lod_chain``
             bitwise the CPU's; two Adam steps, ``save_checkpoint``,
             ``load_checkpoint`` into a fresh model and Adam, and one more
             step from each state, bitwise equal (bytes, save and load ms);
             ``trace()`` around a ``render()``, whose Chrome trace must name
             the compositor and expansion kernels, and the steps'
             ``StageTimer`` spans; the headless CLI: ``--test-model`` at
             512x512 (19,195 non-black pixels, as the JAX CLI; the PNG
             within one u8 level of the CPU's), the 1M random cloud with
             ``--benchmark 24`` (first frame s, steady-state ms/frame) and
             every entry of ``examples/examples.json`` at 128x128 (each PNG
             within one u8 level of the CPU's, lit); the browser viewer over
             HTTP on the 1M scene at 512x512, 24 ``/frame`` requests along an
             orbit, each PNG bitwise a second ``InteractiveRenderer``'s frame
             encoded (both pinned to one bin; request, render and encode
             ms), then ``/select`` (the host numpy count), ``/select/save``,
             ``/select/invert``, ``/select/clear``, ``/export`` and
             ``/info``; the tools: ``ply_to_gcloud --filter-sparse`` on a
             65,536-row PLY (rows bitwise the CPU run's),
             ``compare_aabb_obb``, ``surfel_plane`` and ``orbit_turntable
             --gif`` (PNGs within one u8 level of the CPU's, the GIF's frame
             count);
 22. parallel multi-rank band rendering and training (``parallel/``): the
             kernels built above, a gloo world of 4 spawned ranks sharing the
             card (they load the built libraries): the gloo collectives the
             path uses checked on CUDA tensors; on the 1M bench scene at
             512x512 (4 bands of 128 rows) OBB, AABB and 2DGS frames with the
             all-gather and the bounded exchange (budget and pair hint from
             ``plan_exchange(with_pairs=True)``) and a 4D OBB frame at time
             0.25, each held on rank 0 to the one-device ``render_tiled`` of
             the padded cloud (3e-5, 2DGS 3e-4; 4D: under 1% of values past
             3e-5, none past 0.1) with the count of pixels that differ at
             all, the OBB frame twice (bitwise); one sharded OBB and AABB
             training step whose gradients each rank holds to the one-device
             gradients of the same loss (1e-3 of a field's largest); a
             (camera 2, tiles 2) frame and training step; each rank's
             CUDA-event ms per frame and step, the exchange bytes received per
             rank, and the work ratio (the ranks' device time by the profiler
             over one rank's frame of the whole cloud); then a NCCL world of
             one rank (this process): one band bitwise ``render_tiled`` in
             each mode, and two ranks on one card refused.  Four ranks on one
             card measure work, not scaling.
 23. project the fused serving projection (``ops/cuda/project.py``) on the
             1M 3D bench scene at 1280x720 and the 1M 4DGS scene at 512x512
             (time 0.25): every output bitwise its plain version (the eager
             chain), kernel and plain ms by CUDA events, the byte bound.
 24. sh      the training projection's colour stage (``ops/cuda/sh.py``,
             ``csrc/sh.cu``) on the same scenes and cameras: the forward
             kernel's colour bitwise the eager chain's and the backward
             kernel's d_sh bitwise autograd's; forward and backward kernel
             ms by CUDA events against their byte bounds, and the plain
             version (the eager chain and its autograd) beside them.
 25. project train  the 3DGS training projection (``ProjectCore``,
             ``csrc/project.cu`` project_train_kernel and
             project_bwd_kernel) on the 1M 3D scene at 512x512, OBB and
             AABB: the forward's outputs bitwise the eager chain's, the
             backward's leaf gradients within 1e-3 of its twin; each kernel
             alone by CUDA events against its byte bound, the eager chain
             and its autograd beside them, ptxas's registers and spills.
 26. surface 2DGS training with the surface maps (``train_step(...,
             surface_loss=SurfaceLoss())``) on the 1M scene at 512x512: one
             step with the counters zeroed launches the expansion, the
             surface forward, the backward and the 23-column reduce once
             each; on that step's recorded inputs each kernel against its
             plain twin (colour bitwise the serving instantiation's), and
             kernel, plain and serving-instantiation ms against the bound.

It prints the kernels line (one entry per kernel and mode: the four kernels
in each of the three modes, then the expansion and the forward compositor of
each mode's overlay frames, mode "<mode>+bbox", then the same for 4DGS,
modes "4d-obb", "4d-aabb", "4d-obb+bbox", "4d-aabb+bbox": thirty; the
launches of the expansion and the forward compositor count the serving,
replay, multi-camera, 4D sweep, io, front-end and band frames too, and OBB's
and AABB's backward and reduce the front ends' checkpoint steps and the band
steps, each rank's launches reported to this process), the card's name and power
limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without a card it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_GAUSSIANS = 1_000_000
SIZES = ((512, 512), (1920, 1080))
ORBIT_AZ = (0.0, 0.3, 0.6, 0.9)  # radians about +y, radius 60
TIMED_ROUNDS = 3
# cuda_ms's device-side sleep: cycles of torch.cuda._sleep per second at the
# H100's 1.98 GHz boost clock (at a lower clock it sleeps longer), and its cap
SLEEP_CYCLES_PER_S = 1.98e9
MAX_SLEEP_S = 0.05
LIT_FLOOR = 0.25  # share of pixels with some |rgb| > 1/255
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: HBM3 bandwidth
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet: FP32 outside the tensor cores
# That peak counts an FMA as two operations (132 SMs x 128 lanes x 2 x 1.98
# GHz).  The compositor is built with --fmad=false, so it issues no FMA and
# each of its operations is one instruction: half the peak.
FP32_NO_FMA_OPS_PER_S = FP32_OPS_PER_S / 2
# The expansion is integer work: 64 INT32 lanes per SM (Hopper whitepaper),
# half the FP32 lanes, one operation per instruction.
INT32_OPS_PER_S = FP32_OPS_PER_S / 4
# The compositors' bounds count the least work any implementation does
# (csrc/tile_fwd.cu, csrc/tile_bwd.cu): per walked pair its staging, and per
# (pair, pixel) inside the splat (OBB |u|, |v| <= 1; AABB the radius square
# and power <= 0; 2DGS the surfel's square) its falloff and blend.  Pixels a
# splat does not reach need nothing.  Staging, per walked pair: OBB 8 FP32
# operations (b1 > 0, two clamps, two reciprocals, three selects), 2DGS 2
# (mr / W, mr / H), AABB 0.  The warp mask (csrc/cull.cuh) is not counted:
# it is the cost of the kernels' cull, which a compositor without one does
# not pay.  Forward, per inside (pair, pixel): OBB 30 (offsets 2, u
# 4, v 4, the inside test 4, the exponent 4 and one expf, then the blend:
# g alpha, the cap, w, three multiply-adds, 1 - a, T, 11), AABB 28 (offsets
# 2, the quadratic form 9, the clip 5, one expf, the blend 11), 2DGS 45
# (offsets 2, the square 4, q 12, the clamp and reciprocal 4, us, vs, s3d,
# d2x2 9, min, scale, expf 3, the blend 11).  The overlay adds per inside
# evaluation OBB 8 (the band's max and compare, the gate on the opacity and
# four selects), AABB 10 (also max(r, 1e-12) and the divide), 2DGS 12 (two
# scalings, the max, the clamp, the divide, the compare, the gate and four
# selects).  Backward, per inside (pair, pixel): the falloff (OBB 12, AABB
# 16, 2DGS 4) and 60 / 51 / 105 more (alpha, transmittance, the gradient
# chain and one add into each pixel sum).
STAGE_OPS_PER_PAIR = {"obb": 8, "aabb": 0, "2d": 2}
# The expansion's least work per slot that holds a pair is its tile
# arithmetic: k, its row and column in the owner's rectangle, the tile id
# (12 integer operations).  Finding the owner is not counted: it is the cost
# of one way to find it (a search per slot charged 2 ceil(log2(n + 1)) before).
EXPAND_OPS_PER_PAIR = 12
COMPOSITE_OPS_PER_INSIDE = {"obb": 30, "aabb": 28, "2d": 45}
BBOX_OPS_PER_INSIDE = {"obb": 8, "aabb": 10, "2d": 12}
BACKWARD_OPS_PER_INSIDE = {"obb": 12 + 60, "aabb": 16 + 51, "2d": 4 + 105}
IMAGE_BAR = {"obb": 2e-5, "aabb": 2e-5, "2d": 1e-4}  # kernel vs plain, card vs CPU
ORACLE_BAR = {"obb": 3e-5, "aabb": 3e-5, "2d": 1e-4}  # card vs the port's oracle
GRAD_BAR = 1e-4  # kernel vs plain (and card vs CPU), per gradient column
TRAIN_LR = 1e-3
# timed bench-objective Adam steps per size, each after one warm-up step
TRAIN_STEPS = {SIZES[0]: 10, SIZES[1]: 2}
AABB_TRAIN_STEPS = {SIZES[0]: 5, SIZES[1]: 2}
SURFEL_TRAIN_STEPS = {SIZES[0]: 5, SIZES[1]: 2}
SURFEL_EYE = (2.5, 2.0, 6.0)  # tools/surfel_plane.py's camera
AABB_AFTER_DENSIFY = 2  # steps after densify_and_prune
# convergence_psnr: (steps, n, size, floor in dB).  The bench protocol's floor
# is the JAX package's 16.41 dB (BENCH_r05.json) less the 0.5 dB its own test
# allows (tests/test_train.py); the test protocol's floor is that test's.
CONVERGE = ((120, 512, 128, 15.91), (60, 192, 48, 17.28))
# the rasterize modes beside COLOR (VELOCITY needs 4DGS), by name
VIEW_RASTER_MODES_NAMES = ("DEPTH", "NORMAL", "POSITION", "OPTICAL_FLOW", "CLASSIFICATION")
NORMAL_TRAIN_STEPS = 2  # timed Adam steps in NORMAL mode at 512x512, after a warm-up
# 4DGS: the JAX bench's scene (bench.py:345, random_gaussians_4d_seeded(n,
# seed=3), not rescaled), served at per-frame times 0.25 + 0.01 i
# (bench.py:365) from (0, 0, 60), its pair budget from the worst of three
# times (bench.py:352-357)
SEED_4D = 3
FRAMES_4D = 24
PAIR_TIMES_4D = (0.25, 0.5, 0.75)
TIME_4D = 0.25
TARGET_TIME_4D = 0.3  # the training target: the same cloud at a later time
TRAIN_STEPS_4D = {SIZES[0]: 4, SIZES[1]: 2}  # timed Adam steps, each size after a warm-up
FLAVOUR_FRAMES = 5  # timed render() frames per flavour and size, after a warm-up
COV_BAR = 1e-6  # precomputed covariance against quaternion and scale (tests/test_cov3d.py:85-98)
HALF_BAR = 2e-5  # f16 / bf16 storage against the float32 render of the rounded cloud
SH4_BAR = 2e-6  # SH degree 4 storage against degree 3 (tests/test_sh_degree.py:270-294)
MASK_FLIP_ULPS = 16  # a mask decided apart card vs CPU within this of its threshold is rounding
# serving (InteractiveRenderer), the JAX bench's replay protocol (bench.py:246-300)
SERVE_EL = 0.2
SERVE_RADIUS = 60.0
SERVE_FRAMES = 24  # frames per orbit window
SERVE_WINDOWS = 3
SERVE_TURNS = 8  # turns of the timed bin frame, replay frame and render()
# a replay after a sub-threshold move against a fresh render (tests/test_interactive.py), at each
# pixel beyond the fresh frames' own change under the move (the 1M scene's depth swaps, 2DGS's validity)
SERVE_STALE_BAR = 2e-3
SERVE_HOST_BAR = 2e-6  # InteractiveRenderer.render against render(impl="tiled") (tests/test_interactive.py)
SERVE_FRAMES_4D = 12  # one-pass frames of the 4D time sweep (bench.py:380-389)
BG_BLEND_BAR = 1e-6  # a full-image background frame against the bare frame blended under its transmittance
# IO, scene, query, morph and noise (phase 20) on the 1M scene: 4D, cov3d and the scene's second cloud at a
# smaller depth (paths that are not this slice's); the scene's CPU render at 128x120 on each cloud's first rows (a
# CPU render of the 1M cloud alone takes about 22 s); apply_noise on the CPU on every NOISE_CPU_STRIDE-th row
IO_SMALL_ROWS = 65_536
SCENE_SHIFT = (4.0, 2.0, 12.0)  # the scene's second cloud, moved towards the camera
SCENE_CPU_SIZE = (128, 120)
SCENE_CPU_BAR = 2e-5  # render_scene card vs CPU (tests/test_torch_scene.py's bar against JAX)
INTERP_BAR = 1e-6
PARTICLE_BAR = 1e-5  # ten steps; duplicate behaviours sum in an unspecified order on the card
PARTICLE_STEPS = 10
NOISE_SH_BAR = 1e-5
# the SH colour backward's d_dir and d_dir_t against float64 autograd through the eager chain, norm of the
# difference over norm (tests/torch_port_cases.py SH_GRAD_REL)
SH_GRAD_BAR = 1e-5
PROJECT_TWIN_BAR = 1e-3  # the training projection's backward kernel against its twin (tests/test_torch_cuda.py)
# the 2DGS surface maps, kernel against plain (tests/test_torch_2dgs_geometry.py's card bars): each map's and
# total's norm of difference over norm, the distortion's, and the share of pixels whose median fragment differs
# (where T crosses 0.5 within rounding)
SURFACE_MAP_BAR = 1e-4
SURFACE_DIST_BAR = 1e-3
SURFACE_MEDIAN_SHARE = 1e-4
NOISE_CPU_STRIDE = 64
MESH_BOUNDARY = 1e-5  # a point-in-mesh flip within this of a face or a face's diagonal (unit-box units) is rounding
# the native runtime against the numpy / FlexBuffers paths (phase 20): turns of each load, the PLY bar between the
# two decoders (the JAX package's, tests/test_io.py:276), the radix sort's pairs
NATIVE_TURNS = 5
NATIVE_PLY_BAR = 1e-5
SORT_PAIRS = 1_000_000
# front ends (phase 21) on the 1M scene
STREAM_GRID = (4, 4, 1)
STREAM_RADIUS = 12.0  # holds a few of the grid's 10 x 10 chunks
STREAM_HEIGHT = 8.0  # the camera flies just above the scene's z extent (+-5)
STREAM_PATH = ((-25.0, -15.0), (-15.0, -8.0), (-5.0, -2.0), (5.0, 3.0), (15.0, 8.0), (25.0, 15.0), (-25.0, -15.0))
TEST_MODEL_NON_BLACK = 19_195  # the JAX CLI's --test-model at 512x512 (VERDICT.md:5)
PNG_BAR = 1  # u8 levels, card against CPU
HEADLESS_FRAMES = 24
GALLERY_SIZE = 128
VIEWER_FRAMES = 24
VIEWER_AZ_STEP = 0.02  # radians between the orbit's requests
VIEWER_EL = 0.3
VIEWER_RADIUS = 60.0
VIEWER_RECT = (200, 200, 320, 300)  # the /select rectangle, pixels at 512x512
SPARSE_RADIUS = 0.5  # ply_to_gcloud's filter radius on the bench scene's density
TRACE_KERNELS = ("composite_fwd_kernel", "expand_pairs_kernel")


def log(*args):
    print(*args, flush=True)


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its wall time logged."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[time] {name} {time.perf_counter() - t0:.2f} s")
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events.

    The runs queue behind a device-side sleep that outlasts the host's
    issuing them, so the events bracket the device's work and not the
    host's launch overhead, which exceeds a short kernel's time (a ``fn``
    that synchronises waits the sleep out and is timed with its gaps)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * min(2.0 * reps * issue_s + 1e-3, MAX_SLEEP_S)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_arrays(n: int, seed: int = 0) -> dict:
    from bevy_gaussian_splatting_tpu_torch.models.cloud import random_arrays_3d_seeded

    a = random_arrays_3d_seeded(n, seed=seed)
    a["position_visibility"] = a["position_visibility"] * np.array([1, 1, 0.25, 1], np.float32)
    a["scale_opacity"] = a["scale_opacity"] * np.array([0.05, 0.05, 0.05, 1], np.float32)
    return a


def orbit_camera(az: float, width: int, height: int, device):
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera

    eye = (60.0 * math.sin(az), 0.0, 60.0 * math.cos(az))
    return Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height, device=device)


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from bevy_gaussian_splatting_tpu_torch import native
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tb

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ for the host runtime beside the nvccs
        host = pool.submit(native.load)
        build.build_all()
        seconds = time.perf_counter() - t0
        host.result()
    log(f"[build] {', '.join(build.SOURCES)} built for sm_90a in {seconds:.2f} s; the native host runtime "
        f"({native.CXX} {' '.join(native.FLAGS)}) ready at {time.perf_counter() - t0:.2f} s: "
        f"{native.library_path().name}")
    for name in build.SOURCES:
        for kernel, usage in build.ptxas_usage(name):
            log(f"[build] ptxas {name}.cu {kernel}: {usage}")
    occ = tb.occupancy()
    log("[build] composite_backward resident blocks per SM and dynamic shared memory: "
        + ", ".join(f"{m} {occ[m][0]} blocks, {occ[m][1]} B" for m in ("obb", "aabb", "2d", "2d_surface")))


def bound(nbytes: float, nops: float, ops_per_s: float):
    """Least time (ms) for ``nbytes`` moved and ``nops`` done, and which of
    the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forward_case(comp_args, chunk: int, kmode: int, label: str, reps: int, bbox: bool = False):
    """The forward compositor (``bbox``: its overlay instantiation) against
    its plain version, two launches bitwise equal, timed by CUDA events over
    ``reps`` launches, with the share of (pair, warp) visits its cull keeps
    (from the twin of the mask) -> (raw, pairs walked per tile, (pair,
    pixel) evaluations inside, the kernels-line entry, a log fragment)."""
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import cull
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf

    mode = tf.MODES[kmode]
    params, start, count, tx_count, width, height = comp_args
    num_tiles = start.shape[0]
    kw = dict(chunk=chunk, mode=kmode, bbox=bbox)
    raw = tf.composite_tiles_raw(*comp_args, **kw)
    walked = torch.zeros(num_tiles, dtype=torch.int64, device=params.device)
    inside = torch.zeros_like(walked)
    raw_plain = tf.composite_tiles_raw_plain(*comp_args, tile_batch=512, walked=walked, inside_count=inside, **kw)
    what = f"composite_tiles_raw{' bbox' if bbox else ''} {label}"
    err = float((raw - raw_plain).abs().max())
    if not err <= IMAGE_BAR[mode]:
        raise AssertionError(f"{what}: max |kernel - plain| = {err:.3e} > {IMAGE_BAR[mode]}")
    if not torch.equal(raw.view(torch.int32), tf.composite_tiles_raw(*comp_args, **kw).view(torch.int32)):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    ms = cuda_ms(lambda: tf.composite_tiles_raw(*comp_args, **kw), reps)
    plain_ms = cuda_ms(lambda: tf.composite_tiles_raw_plain(*comp_args, tile_batch=512, **kw), 2)
    share = kept_share(cull.warp_masks(params, start, count, tx_count, width, height, 0, kmode), start, walked)
    n_walked, n_inside = int(walked.sum()), int(inside.sum())
    # the bytes this frame needs: the rows of the walked pairs (the rest of
    # the p_max rows no tile reads), the tile ranges, the output written once
    nbytes = n_walked * params.shape[1] * 4 + 2 * 4 * num_tiles + raw.numel() * 4
    per_inside = COMPOSITE_OPS_PER_INSIDE[mode] + (BBOX_OPS_PER_INSIDE[mode] if bbox else 0)
    ops = n_walked * STAGE_OPS_PER_PAIR[mode] + n_inside * per_inside
    b, by = bound(nbytes, ops, FP32_NO_FMA_OPS_PER_S)
    # names the image's bits, so that runs of two builds of the kernel can be
    # held equal bit for bit from their logs
    digest = hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]
    line = (
        f"composite max_abs_err {err:.3e} (bar {IMAGE_BAR[mode]}), bitwise equal twice (sha256 {digest}), "
        f"{ms:.4f} ms (plain {plain_ms:.4f}, bound {b:.4f} by {by}), pairs walked {n_walked} of "
        f"{int(count.sum())}, (pair, pixel) inside {n_inside}, (pair, warp) visits kept {share:.4f}"
    )
    entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)
    return raw, walked, n_inside, entry, line


def cotangent(raw, target, width: int, height: int):
    """gbar of the bench objective mean((img - target)^2) through the
    epilogue, at the forward's output ``raw``."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tb
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf

    raw_req = raw.detach().requires_grad_()
    img = tf.composite_epilogue(raw_req, None, width, rt.pad_to_tile(height))[:height]
    (grad_raw,) = torch.autograd.grad(torch.mean((img - target) ** 2), raw_req)
    return tb.pack_gbar(grad_raw, raw)


def kept_share(masks, start, walked) -> float:
    """Share of the walked (pair, warp) visits that the compositors' cull
    keeps, from the twin of its mask (``cull.warp_masks``, [P] uint8)."""
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import cull

    _, pairs = cull.tile_pairs(start, walked)  # a tile walks the first walked[t] pairs of its range
    m = masks.to(torch.int64)[pairs]
    kept = sum(int(((m >> b) & 1).sum()) for b in range(cull.WARPS))
    return kept / max(cull.WARPS * pairs.numel(), 1)


def backward_case(bwd_args, chunk: int, kmode: int, label: str, walked, n_inside: int, reps: int):
    """The backward compositor against its plain version (per column within
    GRAD_BAR of its largest |plain|, the radius column exactly 0, two
    launches bitwise equal, every row that the twin of its cull leaves to
    no warp exactly 0 and every row with a plain gradient kept by some
    warp), timed by CUDA events over ``reps`` launches, with the share of
    (pair, warp) visits its cull keeps -> (dparams, the kernels-line entry,
    a log fragment)."""
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import cull
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tb
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf

    mode = tf.MODES[kmode]
    params, start, count, gbar, tx_count, width, height = bwd_args
    dsorted = tb.composite_backward(*bwd_args, chunk=chunk, mode=kmode)
    plain = tb.composite_backward_plain(*bwd_args, chunk=chunk, mode=kmode, tile_batch=512)
    col_max = plain.abs().amax(dim=0)

    col_err = (dsorted - plain).abs().amax(dim=0)
    if not bool((col_err <= GRAD_BAR * col_max).all()):
        rel = (col_err / col_max.clamp(min=1e-30)).tolist()
        raise AssertionError(f"composite_backward {label}: per-column |kernel - plain| / max|plain| "
                             f"{[f'{r:.2e}' for r in rel]} above {GRAD_BAR}")
    mask_col = {"aabb": 5, "2d": 2}.get(mode)  # the radius only masks
    if mask_col is not None and (bool(dsorted[:, mask_col].any()) or bool(plain[:, mask_col].any())):
        raise AssertionError(f"composite_backward {label}: the radius column ({mask_col}) has a gradient")
    # the kernel against the twin of its cull: a row with an empty mask is
    # walked by no warp, and a row with a gradient must be walked by one
    masks = cull.warp_masks(params, start, count, tx_count, width, height, 0, kmode)
    culled = masks == 0
    if bool(dsorted[culled].any()):
        raise AssertionError(f"composite_backward {label}: {int(dsorted[culled].any(dim=1).sum())} rows that the "
                             "twin's mask leaves to no warp have a gradient")
    if bool(((plain != 0).any(dim=1) & culled).any()):
        raise AssertionError(f"composite_backward {label}: the twin's mask leaves out rows with a plain gradient")
    if not torch.equal(dsorted, tb.composite_backward(*bwd_args, chunk=chunk, mode=kmode)):
        raise AssertionError(f"composite_backward {label}: two launches on the same inputs differ")
    col_rel = (col_err / col_max.clamp(min=1e-30)).tolist()
    ms = cuda_ms(lambda: tb.composite_backward(*bwd_args, chunk=chunk, mode=kmode), reps)
    plain_ms = cuda_ms(lambda: tb.composite_backward_plain(*bwd_args, chunk=chunk, mode=kmode, tile_batch=512), 1)
    share = kept_share(masks, start, walked)
    n_walked = int(walked.sum())
    num_tiles = start.shape[0]
    # the backward walks the forward's pairs; its output is all p_max rows
    nbytes = n_walked * params.shape[1] * 4 + 2 * 4 * num_tiles + gbar.numel() * 4 + dsorted.numel() * 4
    ops = n_walked * STAGE_OPS_PER_PAIR[mode] + n_inside * BACKWARD_OPS_PER_INSIDE[mode]
    b, by = bound(nbytes, ops, FP32_NO_FMA_OPS_PER_S)
    line = (
        f"composite_backward per-column |kernel - plain| / max|plain| {' '.join(f'{r:.2e}' for r in col_rel)} "
        f"(bar {GRAD_BAR}), max_abs_err {float(col_err.max()):.3e}, bitwise equal twice, {ms:.4f} ms (plain "
        f"{plain_ms:.4f}, bound {b:.4f} by {by}), (pair, pixel) inside {n_inside} of {n_walked * tf.PIX}, "
        f"(pair, warp) visits kept {share:.4f}, rows culled whole {int(culled.sum())} of {params.shape[0]} (all 0)"
    )
    entry = dict(max_abs_err=float(col_err.max()), ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)
    return dsorted, entry, line


def expand_case(table, p_max: int, tx_count: int, num_tiles: int, label: str, reps: int):
    """The expansion against its plain version (array-equal), timed by CUDA
    events over ``reps`` launches, with its least-work bound and the paths
    its blocks take (from the twin ``block_windows``) -> (the kernels-line
    entry, a log fragment)."""
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as ex

    args = (*table, p_max, tx_count, num_tiles)
    got = ex.expand_pairs(*args)
    ref = ex.expand_pairs_plain(*args)
    for name, g, r in zip(("tile", "g_cloud", "rank"), got, ref):
        if not torch.equal(g, r):
            bad = int((g != r).sum())
            raise AssertionError(f"expand_pairs {label}: {name} differs in {bad} slots")
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref)) if p_max else 0.0
    ms = cuda_ms(lambda: ex.expand_pairs(*args), reps)
    plain_ms = cuda_ms(lambda: ex.expand_pairs_plain(*args), 5)
    pairs = min(int(table[0][-1]), p_max)
    nbytes = sum(t.numel() * 4 for t in table) + 3 * 4 * p_max
    b, by = bound(nbytes, pairs * EXPAND_OPS_PER_PAIR, INT32_OPS_PER_S)
    paths = torch.bincount(ex.block_windows(table[0], p_max).path, minlength=3).tolist()
    line = (f"expand equal, {ms:.4f} ms (plain {plain_ms:.4f}, bound {b:.4f} by {by}), blocks fill / window / "
            f"search {paths[0]} / {paths[1]} / {paths[2]}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None), line


def reduce_case(dslot, cum, n: int, label: str, reps: int):
    """The segmented reduce against its plain version (bit-equal), timed by
    CUDA events over ``reps`` launches beside ``torch.segment_reduce``, with
    its least-work bound and the blocks that stage their run (from the twin
    ``rank_runs``) -> (the kernels-line entry, a log fragment)."""
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as rd

    cols = dslot.shape[1]
    drank = rd.segment_reduce(dslot, cum, n)
    drank_plain = rd.segment_reduce_plain(dslot, cum, n)
    if not torch.equal(drank.view(torch.int32), drank_plain.view(torch.int32)):
        bad = int((drank != drank_plain).any(dim=1).sum())
        raise AssertionError(f"segment_reduce {label}: {bad} of {n} ranks differ from the plain version")
    err = float((drank - drank_plain).abs().max())
    ms = cuda_ms(lambda: rd.segment_reduce(dslot, cum, n), reps)
    plain_ms = cuda_ms(lambda: rd.segment_reduce_plain(dslot, cum, n), 2)
    owned = int(cum[-1])
    _, lengths = rd.segment_bounds(cum)
    owned_rows = dslot[:owned]
    lib = torch.segment_reduce(owned_rows, "sum", lengths=lengths, axis=0)
    lib_err = float((lib - drank).abs().max())
    lib_ms = cuda_ms(lambda: torch.segment_reduce(owned_rows, "sum", lengths=lengths, axis=0), reps)
    b, by = bound(owned * cols * 4 + n * 4 + n * cols * 4, owned * cols, FP32_NO_FMA_OPS_PER_S)
    runs = rd.rank_runs(cum, n, cols)
    line = (f"segment_reduce equal over {n} ranks, {owned} slots x {cols} columns, {ms:.4f} ms (plain "
            f"{plain_ms:.4f}, bound {b:.4f} by {by}, torch.segment_reduce {lib_ms:.4f}, differs by {lib_err:.3e}), "
            f"blocks staged {int(runs.staged.sum())} of {runs.staged.shape[0]}, in two or more windows "
            f"{int((runs.windows >= 2).sum())}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms), line


def phase_kernels(cloud, target_cloud, settings, width: int, height: int, target_time=None) -> dict:
    """Each kernel against its plain version on this frame's real inputs, in
    the compositors' mode for ``settings``.  With ``target_time`` (4DGS) the
    backward's cotangent comes from a render of ``cloud`` at that time, and
    the line adds the pair truncation and the twins' counts of the
    expansion's search blocks and the reduce's unstaged blocks."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import expand as ex
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import reduce as rd
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf

    dev = cloud.device
    kmode = rt.kernel_mode(settings)
    four_d = settings.gaussian_mode == GaussianMode.GAUSSIAN_4D
    mode = tf.MODES[kmode]
    label = f"{'4d ' if four_d else ''}{mode} {width}x{height}"
    camera = orbit_camera(0.0, width, height, dev)
    n = len(cloud)
    total = int(rt.pair_count(cloud, camera, settings))
    p_max = rt.pairs_budget(n, total)
    splats = rt.project_for_binning(cloud, camera, settings)
    tx_count = width // rt.TILE
    num_tiles = tx_count * (rt.pad_to_tile(height) // rt.TILE)

    if kmode == tf.MODE_OBB and not four_d:
        # radix keys (the same in every mode): the card's against the CPU's,
        # counted (ROADMAP Queue 3)
        keys_card = splats["sort_key"].cpu()
        cpu_cloud, cpu_cam = cloud.to("cpu"), orbit_camera(0.0, width, height, "cpu")
        keys_cpu = rt.project_for_binning(cpu_cloud, cpu_cam, settings)["sort_key"]
        log(f"[keys {width}x{height}] radix keys differing card vs cpu: {int((keys_card != keys_cpu).sum())} of {n}")

    # ---- pair expansion: array-equal ----
    table, _ = rt.expansion_inputs(splats, width, height, p_max)
    expand, exp_line = expand_case(table, p_max, tx_count, num_tiles, label, 20)

    # ---- compositor: within 2e-5 (2DGS 1e-4) ----
    bins = rt.tile_bins(splats, width, height, p_max)
    params = splats["params"][bins.g_s].contiguous()
    start, count = bins.start, bins.count
    chunk = tf.preferred_chunk(p_max, num_tiles)
    comp_args = (params, start, count, tx_count, width, height)
    raw, walked, n_inside, comp, comp_line = forward_case(comp_args, chunk, kmode, label, 20)

    # ---- the overlay instantiation against the plain overlay ----
    raw_b, _, _, bbox_entry, bbox_fwd_line = forward_case(comp_args, chunk, kmode, label, 20, bbox=True)
    closed = int((raw_b[:, 3] == 0.0).sum())  # an edge sets T to exactly 0
    green = int(((raw_b[:, :3] - torch.tensor(tf.BBOX_GREEN, device=dev)[None, :, None]).abs().amax(dim=1) < 1e-6).sum())
    if closed <= 0 or green <= 0:
        raise AssertionError(f"composite_tiles_raw bbox {label}: no edge pixel ({closed} closed, {green} green)")
    bbox_line = (
        f"[kernels {label} bbox] {bbox_fwd_line}; without the overlay {comp['ms']:.4f} ms, "
        f"{int(walked.sum())} pairs walked; pixels closed by an edge (T = 0) {closed}, pure green {green} of "
        f"{num_tiles * tf.PIX}"
    )

    # ---- backward compositor: per column within GRAD_BAR of its largest |plain| ----
    # the cotangent of a real loss: the bench objective against a render of
    # the moved cloud, through the epilogue
    with torch.no_grad():
        if target_time is None:
            target = rt.render_tiled(target_cloud, camera, settings, pairs_max=p_max)
        else:
            target = rt.render_tiled(cloud, camera, settings, pairs_max=p_max, time=target_time)
    gbar = cotangent(raw, target, width, height)
    bwd_args = (params, start, count, gbar, tx_count, width, height)
    dsorted, bwd, bwd_line = backward_case(bwd_args, chunk, kmode, label, walked, n_inside, 10)

    # ---- segmented reduce: array-equal, at the mode's row width ----
    dslot = torch.empty_like(dsorted)
    dslot[bins.order] = dsorted
    reduce, red_line = reduce_case(dslot, bins.cum, n, label, 20)
    log(f"[kernels {label}] pairs {total} p_max {p_max} chunk {chunk} | {exp_line} | {comp_line}")
    log(f"[kernels {label}] {bwd_line} | {red_line}")
    log(bbox_line)
    if four_d:
        search = int((ex.block_windows(table[0], p_max).path == 2).sum())
        runs = rd.rank_runs(bins.cum, n, dsorted.shape[1])
        longest = int(torch.diff(bins.cum.to(torch.int64), prepend=bins.cum.new_zeros(1)).max())
        windows = torch.bincount(runs.windows).tolist()
        log(f"[kernels {label}] at time {settings.time}: pairs {total}, p_max {p_max}, truncated "
            f"{max(total - p_max, 0)}; expansion blocks on the per-slot search path {search}; reduce blocks "
            f"unstaged {int((~runs.staged).sum())} of {runs.staged.shape[0]}, by windows of "
            f"{rd.STAGE_FLOATS // dsorted.shape[1]} rows {windows} (longest rank {longest} rows)")
    return {
        "expand_pairs": expand,
        "composite_tiles_raw": comp,
        "composite_backward": bwd,
        "segment_reduce": reduce,
        "composite_tiles_raw+bbox": bbox_entry,
    }


def phase_kernels_converge() -> None:
    """The four kernels at the convergence protocols' shapes (AABB,
    ``CONVERGE``): the protocol's starting cloud (``_init_arrays``) seen from
    its first view, with ``render_tiled``'s default pair budget; each kernel
    against its plain version and timed by CUDA events over 200 launches,
    with its bound; the cotangent from the bench objective against the
    test model's render, the reduce's rows from the backward."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, test_model_3d
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf
    from bevy_gaussian_splatting_tpu_torch.train.quality import _init_arrays

    settings = CloudSettings(aabb=True)
    kmode = rt.kernel_mode(settings)
    target_cloud = test_model_3d(seed=11, device="cuda")
    for _, n, size, _ in CONVERGE:
        label = f"aabb converge n {n} {size}x{size}"
        cloud = cloud_from_numpy(_init_arrays(target_cloud, n, 0), "cuda")
        camera = Camera.create(eye=(0.0, 1.0, 5.0), target=(0, 0, 0), width=size, height=size, device="cuda")
        p_max = rt.pairs_budget(n)
        splats = rt.project_for_binning(cloud, camera, settings)
        bins = rt.tile_bins(splats, size, size, p_max)
        params = splats["params"][bins.g_s].contiguous()
        tx_count = size // rt.TILE
        num_tiles = bins.start.shape[0]
        table, _ = rt.expansion_inputs(splats, size, size, p_max)
        exp_line = expand_case(table, p_max, tx_count, num_tiles, label, 200)[1]
        chunk = tf.preferred_chunk(p_max, num_tiles)
        comp_args = (params, bins.start, bins.count, tx_count, size, size)
        raw, walked, n_inside, _, fwd_line = forward_case(comp_args, chunk, kmode, label, 200)
        with torch.no_grad():
            target = rt.render_tiled(target_cloud, camera, settings)
        bwd_args = (params, bins.start, bins.count, cotangent(raw, target, size, size), tx_count, size, size)
        dsorted, _, bwd_line = backward_case(bwd_args, chunk, kmode, label, walked, n_inside, 200)
        dslot = torch.empty_like(dsorted)
        dslot[bins.order] = dsorted
        red_line = reduce_case(dslot, bins.cum, n, label, 200)[1]
        log(f"[kernels {label}] pairs {int(bins.count.sum())} p_max {p_max} chunk {chunk} | {exp_line} | "
            f"{fwd_line} | {bwd_line} | {red_line}")


def small_grads(arrays: dict, camera, background, settings, device, target_time=None) -> dict:
    """Gradients of every cloud field of the bench objective against a
    render of the moved cloud (4DGS: of the same cloud at ``target_time``),
    on ``device``."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.train.losses import mse
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, shifted_arrays

    camera, background = camera.to(device), background.to(device)
    with torch.no_grad():
        if target_time is None:
            target = render_tiled(cloud_from_numpy(shifted_arrays(arrays), device), camera, settings,
                                  background=background)
        else:
            target = render_tiled(cloud_from_numpy(arrays, device), camera, settings, background=background,
                                  time=target_time)
    model = TrainableCloud.from_numpy(arrays, device)
    mse(render_tiled(model.cloud(), camera, settings, background=background), target).backward()
    return {name: getattr(model, name).grad.cpu() for name in model.fields}


def compare_small(label: str, arrays: dict, cam, settings, bg, oracle_only: bool = False, cpu_bar=None):
    """``render()`` on the card against the port's oracle on the card (3e-5;
    2DGS 1e-4) and, unless ``oracle_only``, against the same call on the
    CPU (``cpu_bar``, default 2e-5; 2DGS 1e-4) -> the card's image."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode
    from bevy_gaussian_splatting_tpu_torch.render.api import render

    mode = MODES[kernel_mode(settings)]
    cpu_bar = IMAGE_BAR[mode] if cpu_bar is None else cpu_bar
    card = cloud_from_numpy(arrays, "cuda")
    gpu = render(card, cam.to("cuda"), settings, background=bg.cuda())
    oracle = render(card, cam.to("cuda"), settings, background=bg.cuda(), impl="oracle")
    e_oracle = float((gpu - oracle).abs().max())
    line = f"[small {label}] card vs oracle {e_oracle:.3e} (bar {ORACLE_BAR[mode]})"
    e_cpu = 0.0
    if not oracle_only:
        cpu = render(cloud_from_numpy(arrays, "cpu"), cam, settings, background=bg, device="cpu")
        e_cpu = float((gpu.cpu() - cpu).abs().max())
        line += f", card vs cpu {e_cpu:.3e} (bar {cpu_bar:.3e})"
    log(line)
    if not (e_cpu <= cpu_bar and e_oracle <= ORACLE_BAR[mode]):
        raise AssertionError(f"small render {label} disagrees: cpu {e_cpu:.3e}, oracle {e_oracle:.3e}")
    return gpu


def phase_small(settings) -> None:
    """Small inputs: card against the oracle and against the CPU, images and
    gradients; for 2DGS also on the surfel grid; then ``render()`` with the
    overlay."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import surfel_grid_arrays
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODE_2D, MODES

    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    mode = MODES[kernel_mode(settings)]
    scenes = [("bench2000", bench_arrays(2000, seed=3), None)]
    if kernel_mode(settings) == MODE_2D:
        scenes.append(("surfels", surfel_grid_arrays(), SURFEL_EYE))
    for scene, a, eye in scenes:
        for width, height in ((128, 128), (128, 120)):
            label = f"{mode} {scene} {width}x{height}"
            if eye is None:
                cam = orbit_camera(0.0, width, height, "cpu")
            else:
                cam = Camera.create(eye=eye, target=(0.0, 0.0, 0.0), width=width, height=height, device="cpu")
            compare_small(label, a, cam, settings, bg)
            g_cpu = small_grads(a, cam, bg, settings, "cpu")
            g_card = small_grads(a, cam, bg, settings, "cuda")
            rel = grads_rel(g_card, g_cpu, label)
            log(f"[small {label}] gradients card vs cpu, max |diff| / max |cpu| per field: "
                + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f" (bar {GRAD_BAR})")
            if mode == "2d" and (bool(g_card["scale_opacity"][:, 2].any()) or bool(g_cpu["scale_opacity"][:, 2].any())):
                raise AssertionError(f"small gradients {label}: the flat surfel's scale z has a gradient")
    # the overlay, served, on a cloud with no opacity 0 (edges are gated by
    # the opacity on the tiled path and by the mask in the oracle)
    a = scenes[0][1]
    if not float(a["scale_opacity"][:, 3].min()) > 0.0:
        raise AssertionError("the overlay's small cloud has an opacity of 0")
    compare_small(f"{mode} bench2000 128x120 bbox", a, orbit_camera(0.0, 128, 120, "cpu"),
                  settings.replace(visualize_bounding_box=True), bg)


def grads_rel(g_card: dict, g_cpu: dict, label: str, bars: dict = None) -> dict:
    """Per field max |card - cpu| / max |cpu|; raises above the field's bar
    (``bars``, default GRAD_BAR) or on a non-finite card gradient."""
    bars = bars or {}
    rel = {}
    for name in g_cpu:
        if not bool(torch.isfinite(g_card[name]).all()):
            raise AssertionError(f"small gradients {label}: {name} not finite on the card")
        scale = float(g_cpu[name].abs().max())
        rel[name] = float((g_card[name] - g_cpu[name]).abs().max()) / max(scale, 1e-30)
    if not all(v <= bars.get(k, GRAD_BAR) for k, v in rel.items()):
        raise AssertionError(f"small gradients {label} disagree card vs cpu: {rel} (bars {bars or GRAD_BAR})")
    return rel


def view_modes():
    """(label, settings) of each rasterize and draw mode beside COLOR/ALL."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, DrawMode, RasterizeMode

    out = [(m.lower(), CloudSettings(rasterize_mode=RasterizeMode[m], num_classes=4)) for m in VIEW_RASTER_MODES_NAMES]
    return out + [(d.name.lower(), CloudSettings(draw_mode=d)) for d in (DrawMode.SELECTED, DrawMode.HIGHLIGHT_SELECTED)]


def phase_small_views() -> None:
    """OBB on small inputs: each rasterize and draw mode, card against the
    CPU and the oracle; the STD and RAYON sorts against the oracle; the
    overlay's training route (gradients card against CPU); and the overlay on
    a cloud with opacity-0 gaussians, whose boxes only the oracle draws."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, SortMode
    from bevy_gaussian_splatting_tpu_torch.render.api import render
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy

    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    width, height = 128, 120
    a = bench_arrays(2000, seed=3)
    # visibilities over [0, 5]: the draw modes select at 0.5, classes start at 2
    levels = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    a["position_visibility"][:, 3] = np.random.default_rng(11).choice(levels, len(a["position_visibility"]))
    # the optical flow's previous view: a neighbouring eye
    prev = orbit_camera(0.02, width, height, "cpu")
    cam = Camera.create(eye=(0.0, 0.0, 60.0), width=width, height=height, device="cpu",
                        prev_clip_from_world=prev.clip_from_world.numpy())
    for name, settings in view_modes():
        compare_small(f"obb {name} {width}x{height}", a, cam, settings, bg)
    for sort_mode in (SortMode.STD, SortMode.RAYON):
        compare_small(f"obb sort {sort_mode.name} {width}x{height}", a, cam, CloudSettings(sort_mode=sort_mode), bg,
                      oracle_only=True)

    # the overlay's training route: plain compositing under autograd
    overlay = CloudSettings(visualize_bounding_box=True)
    square = orbit_camera(0.0, 128, 128, "cpu")
    g_cpu = small_grads(a, square, bg, overlay, "cpu")
    g_card = small_grads(a, square, bg, overlay, "cuda")
    rel = grads_rel(g_card, g_cpu, "obb bbox training 128x128")
    log("[small obb bbox training 128x128] gradients card vs cpu, max |diff| / max |cpu| per field: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f" (bar {GRAD_BAR})")

    # opacity 0 in the mask (cutoff 3, so the quad keeps its size): the
    # oracle boxes it, the tiled path does not (ROADMAP Queue 3)
    z = bench_arrays(2000, seed=3)
    z["scale_opacity"][::4, 3] = 0.0
    zero = CloudSettings(visualize_bounding_box=True, opacity_adaptive_radius=False)
    tiled = render(cloud_from_numpy(z, "cuda"), square.to("cuda"), zero)
    cpu = render(cloud_from_numpy(z, "cpu"), square, zero, device="cpu")
    oracle = render(cloud_from_numpy(z, "cuda"), square.to("cuda"), zero, impl="oracle")
    e_cpu = float((tiled.cpu() - cpu).abs().max())
    differ = int(((tiled - oracle).abs().amax(dim=-1) > 1e-3).sum())
    log(f"[small obb opacity-0 bbox 128x128] card vs cpu {e_cpu:.3e} (bar {IMAGE_BAR['obb']}); pixels where the "
        f"oracle and the tiled path differ by > 1e-3: {differ} of {128 * 128}")
    if not e_cpu <= IMAGE_BAR["obb"]:
        raise AssertionError(f"opacity-0 overlay card vs cpu {e_cpu:.3e}")


def phase_main(cloud, settings, profile: bool, rounds: int = TIMED_ROUNDS) -> dict:
    """The serving path through ``render()``; counters read per frame.  The
    compositor's launches are counted per instantiation (mode, overlay)."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.reduce import segment_reduce
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_bwd import composite_backward
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES, composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    dev = cloud.device
    mode = MODES[rt.kernel_mode(settings)]
    bbox = settings.visualize_bounding_box
    label0 = mode + ("+bbox" if bbox else "")
    instance = (mode, bbox)

    def counts():
        return expand_pairs.launches, composite_tiles_raw.instances.get(instance, 0)

    idle = (composite_backward, segment_reduce)  # serving runs no backward
    launches = {"expand_pairs": 0, "composite_tiles_raw": 0}
    for f in idle:
        f.launches = 0
    for width, height in SIZES:
        label = f"{label0} {width}x{height}"
        cams = [orbit_camera(az, width, height, dev) for az in ORBIT_AZ]
        pairs = [int(rt.pair_count(cloud, c, settings)) for c in cams]
        times = []
        expand_pairs.launches = 0
        composite_tiles_raw.instances.clear()
        for rnd in range(rounds + 1):  # round 0 warms up
            for cam in cams:
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = api.render(cloud, cam, settings)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                for name, b, a in zip(launches, before, counts()):
                    if a <= b:
                        raise AssertionError(f"{name} {instance} did not launch in a {label} frame")
                if img.shape != (height, width, 4) or not bool(torch.isfinite(img).all()):
                    raise AssertionError(f"bad image {tuple(img.shape)} at {label}")
                lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
                if lit < LIT_FLOOR * width * height:
                    raise AssertionError(f"only {lit} lit pixels at {label}")
                if rnd:
                    times.append(dt)
        for name, n in zip(launches, counts()):
            launches[name] += n
        if any(f.launches for f in idle):
            raise AssertionError(f"a backward kernel launched while serving at {label}")
        if set(composite_tiles_raw.instances) != {instance}:
            raise AssertionError(f"{label}: compositor instantiations {composite_tiles_raw.instances} launched")
        bucket = api._BUDGET_STATE[api.budget_key("auto", settings, width, height, cloud, dev)][0]
        log(
            f"[main {label}] pairs per pose {pairs} p_max {bucket} "
            f"lit {lit} | median {statistics.median(times):.3f} ms/frame over {len(times)} frames "
            f"(min {min(times):.3f}, max {max(times):.3f}) | launches expand_pairs {counts()[0]}, "
            f"composite_tiles_raw{list(instance)} {counts()[1]}"
        )
        if profile:
            profile_call(lambda: api.render(cloud, cams[0], settings), f"{label0}_{width}x{height}",
                         statistics.median(times))
    return launches


def phase_main_views(cloud) -> None:
    """One ``render()`` frame per rasterize mode beside COLOR and per size
    (OBB): finite, lit, through both forward kernels."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, RasterizeMode
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    for width, height in SIZES:
        cam = orbit_camera(0.0, width, height, cloud.device)
        parts = []
        for name in VIEW_RASTER_MODES_NAMES:
            settings = CloudSettings(rasterize_mode=RasterizeMode[name])
            before = (expand_pairs.launches, composite_tiles_raw.instances.get(("obb", False), 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = api.render(cloud, cam, settings)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            after = (expand_pairs.launches, composite_tiles_raw.instances.get(("obb", False), 0))
            if not all(a > b for a, b in zip(after, before)):
                raise AssertionError(f"{name} {width}x{height}: a forward kernel did not launch")
            lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
            if img.shape != (height, width, 4) or not bool(torch.isfinite(img).all()) or lit < LIT_FLOOR * width * height:
                raise AssertionError(f"bad {name} image at {width}x{height} ({lit} lit pixels)")
            parts.append(f"{name.lower()} lit {lit}, {dt:.3f} ms")
        log(f"[main views obb {width}x{height}] one frame each (the first of its pipeline key): " + "; ".join(parts))


def profile_call(fn, label: str, wall_ms: float) -> None:
    """Device time by kernel for one warm call of ``fn``, as a table in the
    output directory.  The idle share is taken against ``wall_ms``, the
    unprofiled median, since the profiler slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # CUDA-side rows named like a CPU op are annotations (the optimizer's
    # step range), not kernels: leave them out of the busy sum
    cpu_ops = {e.key for e in events if e.device_type == DeviceType.CPU}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in cpu_ops]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    table = events.table(sort_by="self_cuda_time_total", row_limit=60)
    (out / f"profile_{label}.txt").write_text(table)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(
        f"[profile {label}] {sum(e.count for e in kernels)} kernel launches, device busy "
        f"{busy_ms:.3f} ms of a {wall_ms:.3f} ms call, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; top: "
        + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top)
    )


def train_counters() -> tuple:
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.reduce import segment_reduce
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_bwd import composite_backward
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw

    return (expand_pairs, composite_tiles_raw, composite_backward, segment_reduce)


def checked_step(model, optimizer, camera, target, settings, loss_fn, p_max, label):
    """One ``train_step`` that must launch all four kernels, in COLOR the
    colour stage's forward kernel too (``sh.fused``), and leave a finite
    loss and finite gradients -> (loss, host ms)."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import RasterizeMode
    from bevy_gaussian_splatting_tpu_torch.train.step import train_step
    from bevy_gaussian_splatting_tpu_torch.utils import trace

    counters = train_counters()
    before = [f.launches for f in counters]
    sh_before = trace.counters().get("sh.fused", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = train_step(model, optimizer, camera, target, settings, loss_fn, pairs_max=p_max)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    for f, b in zip(counters, before):
        if f.launches <= b:
            raise AssertionError(f"{f.__name__} did not launch in the {label}")
    if settings.rasterize_mode == RasterizeMode.COLOR and trace.counters().get("sh.fused", 0) <= sh_before:
        raise AssertionError(f"the colour stage's kernels did not launch in the {label}")
    value = float(loss)
    # a field the loss does not read has no gradient (NORMAL mode reads no SH)
    grads = {name: getattr(model, name).grad for name in model.fields}
    bad = [name for name, g in grads.items() if g is not None and not bool(torch.isfinite(g).all())]
    if not math.isfinite(value) or bad:
        raise AssertionError(f"{label}: loss {value}, non-finite gradients in {bad}")
    return value, dt


def train_target(model, target_cloud, settings, width: int, height: int):
    """The pose-0 camera, the pair budget from the model's measured count,
    and a render of ``target_cloud`` -> (camera, p_max, pairs, target)."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt

    camera = orbit_camera(0.0, width, height, "cuda")
    with torch.no_grad():
        pairs = int(rt.pair_count(model.cloud(), camera, settings))
        p_max = rt.pairs_budget(len(model.cloud()), pairs)
        target = rt.render_tiled(target_cloud, camera, settings, pairs_max=p_max)
    return camera, p_max, pairs, target


def phase_train(arrays: dict, settings, steps: dict, gs_loss: bool, profile: bool) -> dict:
    """The training path through ``train_step``; counters read per step.
    ``steps`` timed Adam steps per size, each size after one warm-up;
    ``gs_loss`` adds two ``gaussian_splatting_loss`` steps at the first
    size."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode
    from bevy_gaussian_splatting_tpu_torch.train.losses import gaussian_splatting_loss, mse
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, shifted_arrays, train_step

    mode = MODES[kernel_mode(settings)]
    counters = train_counters()
    model = TrainableCloud.from_numpy(arrays, "cuda")
    target_cloud = cloud_from_numpy(shifted_arrays(arrays), "cuda")
    optimizer = adam(model, TRAIN_LR)
    for f in counters:
        f.launches = 0

    def step(camera, target, p_max, loss_fn, label):
        return checked_step(model, optimizer, camera, target, settings, loss_fn, p_max, f"{mode} {label}")

    for width, height in SIZES:
        camera, p_max, pairs, target = train_target(model, target_cloud, settings, width, height)
        size = f"{width}x{height}"
        first, warm_ms = step(camera, target, p_max, mse, f"{size} warm-up step")
        timed = steps[(width, height)]
        losses, times = [], []
        for i in range(timed):
            value, dt = step(camera, target, p_max, mse, f"{size} step {i}")
            losses.append(value)
            times.append(dt)
        median = statistics.median(times)
        line = (
            f"[train {mode} {size}] pairs {pairs} p_max {p_max} | warm-up {warm_ms:.3f} ms, median {median:.3f} "
            f"ms/step over {timed} Adam steps (min {min(times):.3f}, max {max(times):.3f}) | mse loss {first:.6e} -> "
            f"{losses[-1]:.6e}"
        )
        if (width, height) == SIZES[0]:
            if not losses[-1] < first:
                raise AssertionError(f"train {mode} {size}: the loss did not fall ({first:.6e} -> {losses[-1]:.6e})")
            if gs_loss:
                # two steps: the first call of the SSIM convolutions sets cuDNN up
                gs = [step(camera, target, p_max, gaussian_splatting_loss, f"{size} gaussian_splatting_loss step")
                      for _ in range(2)]
                line += (f" | gaussian_splatting_loss steps {gs[0][1]:.3f}, {gs[1][1]:.3f} ms, "
                         f"loss {gs[0][0]:.6e} -> {gs[1][0]:.6e}")
        log(line + " | launches " + ", ".join(f"{f.__name__} {f.launches}" for f in counters))
        if profile:
            profile_call(lambda: train_step(model, optimizer, camera, target, settings, mse, pairs_max=p_max),
                         f"train_{mode}_{size}", median)
    return {f.__name__: f.launches for f in counters}


def phase_train_aabb(arrays: dict, settings, profile: bool) -> dict:
    """The AABB training loop's pieces on the bench scene: Adam steps with
    ``accumulate_stats`` after each, one ``densify_and_prune`` and a fresh
    Adam, and two more steps; counters read per step."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.train.densify import (
        accumulate_stats,
        densify_and_prune,
        init_densify_state,
    )
    from bevy_gaussian_splatting_tpu_torch.train.losses import mse
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, shifted_arrays, train_step

    counters = train_counters()
    model = TrainableCloud.from_numpy(arrays, "cuda")
    target_cloud = cloud_from_numpy(shifted_arrays(arrays), "cuda")
    optimizer = adam(model, TRAIN_LR)
    dstate = init_densify_state(len(model.cloud()), device="cuda")
    for f in counters:
        f.launches = 0

    def step(camera, target, p_max, label):
        nonlocal dstate
        value, dt = checked_step(model, optimizer, camera, target, settings, mse, p_max, label)
        dstate = accumulate_stats(dstate, model.grads())
        return value, dt

    for width, height in SIZES:
        camera, p_max, pairs, target = train_target(model, target_cloud, settings, width, height)
        size = f"{width}x{height}"
        first, warm_ms = step(camera, target, p_max, f"aabb {size} warm-up step")
        steps = [step(camera, target, p_max, f"aabb {size} step {i}") for i in range(AABB_TRAIN_STEPS[(width, height)])]
        times = [dt for _, dt in steps]
        median = statistics.median(times)
        log(
            f"[train aabb {size}] pairs {pairs} p_max {p_max} | warm-up {warm_ms:.3f} ms, median {median:.3f} "
            f"ms/step over {len(steps)} Adam steps (min {min(times):.3f}, max {max(times):.3f}) | mse loss "
            f"{first:.6e} -> {steps[-1][0]:.6e} | launches " + ", ".join(f"{f.__name__} {f.launches}" for f in counters)
        )
        if profile:
            profile_call(lambda: train_step(model, optimizer, camera, target, settings, mse, pairs_max=p_max),
                         f"train_aabb_{size}", median)

    with torch.no_grad():
        lo, hi = model.cloud().compute_aabb()
        extent = float((hi - lo).max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_cloud, dstate, stats = densify_and_prune(
        model.cloud(), dstate, k_budget=len(model.cloud()) // 8, scene_extent=extent
    )
    with torch.no_grad():
        for name in model.fields:
            getattr(model, name).copy_(getattr(new_cloud, name))
    torch.cuda.synchronize()
    densify_ms = (time.perf_counter() - t0) * 1e3
    optimizer = adam(model, TRAIN_LR)
    stats = {k: int(v) for k, v in stats.items()}
    camera, p_max, pairs, target = train_target(model, target_cloud, settings, *SIZES[0])
    after = [step(camera, target, p_max, f"aabb step {i} after densify") for i in range(AABB_AFTER_DENSIFY)]
    log(
        f"[train aabb densify] densify_and_prune(k_budget={len(model.cloud()) // 8}, scene_extent={extent:.4f}) "
        f"{densify_ms:.3f} ms, stats {json.dumps(stats)} | {SIZES[0][0]}x{SIZES[0][1]} after it: pairs {pairs}, "
        f"steps {', '.join(f'{dt:.3f}' for _, dt in after)} ms, mse loss {after[-1][0]:.6e} | launches "
        + ", ".join(f"{f.__name__} {f.launches}" for f in counters)
    )
    return {f.__name__: f.launches for f in counters}


def phase_train_normal(arrays: dict) -> dict:
    """Training in NORMAL mode, whose colour depends on rotation and scale:
    a warm-up and ``NORMAL_TRAIN_STEPS`` Adam steps at the first size; every
    step through all four kernels, finite."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, RasterizeMode
    from bevy_gaussian_splatting_tpu_torch.train.losses import mse
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, shifted_arrays

    settings = CloudSettings(rasterize_mode=RasterizeMode.NORMAL)
    counters = train_counters()
    model = TrainableCloud.from_numpy(arrays, "cuda")
    target_cloud = cloud_from_numpy(shifted_arrays(arrays), "cuda")
    optimizer = adam(model, TRAIN_LR)
    for f in counters:
        f.launches = 0
    camera, p_max, pairs, target = train_target(model, target_cloud, settings, *SIZES[0])
    size = f"{SIZES[0][0]}x{SIZES[0][1]}"
    steps = [checked_step(model, optimizer, camera, target, settings, mse, p_max, f"normal {size} step {i}")
             for i in range(NORMAL_TRAIN_STEPS + 1)]
    log(
        f"[train normal {size}] pairs {pairs} p_max {p_max} | warm-up {steps[0][1]:.3f} ms, steps "
        f"{', '.join(f'{dt:.3f}' for _, dt in steps[1:])} ms | mse loss {steps[0][0]:.6e} -> {steps[-1][0]:.6e} | "
        "launches " + ", ".join(f"{f.__name__} {f.launches}" for f in counters)
    )
    return {f.__name__: f.launches for f in counters}


def phase_converge() -> dict:
    """``convergence_psnr`` on the card at the bench and test protocols."""
    from bevy_gaussian_splatting_tpu_torch.train.quality import convergence_psnr

    counters = train_counters()
    for f in counters:
        f.launches = 0
    for steps, n, size, floor in CONVERGE:
        out = convergence_psnr(steps=steps, n=n, size=size)
        log(
            f"[converge steps {steps} n {n} size {size}] psnr {out['psnr_db']:.4f} dB (floor {floor}), "
            f"per view {' '.join(f'{v:.4f}' for v in out['psnr_per_view'])}, loss {out['losses'][0]:.6e} -> "
            f"{out['final_loss']:.6e}, densify {json.dumps(out['densify'])}, {out['seconds']:.2f} s wall"
        )
        if not (math.isfinite(out["psnr_db"]) and out["psnr_db"] >= floor):
            raise AssertionError(f"convergence_psnr {steps}/{n}/{size}: {out['psnr_db']:.4f} dB below {floor}")
    launches = {f.__name__: f.launches for f in counters}
    log("[converge] launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    return launches


def mask_flips(arrays: dict, settings, camera) -> tuple:
    """4DGS gaussians that the card and the CPU mask differently (the
    projection's mask and its radix key's frustum test) -> (count, the
    largest distance of a flipped gaussian from its nearest threshold, in
    float32 ulps of that threshold, on the CPU's values): the temporal
    marginal against 0.05, the clip x and y of the shifted and the stored
    position against 1.1, z against 0 and 1.  Matrix products and exp may
    round an ulp apart on the two devices, and each test is a step."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops
    from bevy_gaussian_splatting_tpu_torch.ops.gaussian_4d import MARGINAL_MASK_THRESHOLD, conditional_cov3d
    from bevy_gaussian_splatting_tpu_torch.ops.project import project_gaussians
    from bevy_gaussian_splatting_tpu_torch.ops.transforms import world_to_clip

    masks = {}
    for dev in ("cpu", "cuda"):
        sp = project_gaussians(cloud_from_numpy(arrays, dev), camera.to(dev), settings)
        masks[dev] = (sp["mask"] & (sp["sort_key"] != sort_ops.SENTINEL_KEY)).cpu()
    flip = masks["cpu"] != masks["cuda"]
    if not bool(flip.any()):
        return 0, 0.0
    c = cloud_from_numpy(arrays, "cpu")
    cond = conditional_cov3d(c.rotation, c.rotation_r, c.scale, c.timescale, c.timestamp,
                             torch.full((), settings.time, dtype=torch.float32), settings.global_scale)

    def ulps(v, threshold):
        return (v - threshold).abs() / float(np.spacing(np.float32(threshold)))

    near = [ulps(cond["opacity_modifier"], MARGINAL_MASK_THRESHOLD)]
    for pos in (c.position + cond["delta_mean"], c.position):
        clip = world_to_clip(pos, camera.clip_from_world)
        near += [ulps(clip[:, 0].abs(), 1.1), ulps(clip[:, 1].abs(), 1.1), ulps(clip[:, 2], 0.0), ulps(clip[:, 2], 1.0)]
    far = torch.stack(near).amin(dim=0)[flip]
    return int(flip.sum()), float(far.max())


def phase_small_4d(settings) -> None:
    """4DGS on small inputs (2,000 gaussians of the 4DGS generator): at two
    times each, ``render()`` card against the oracle and the CPU, and the
    image must move with the time; gradients of every field card against
    CPU (the target: the same cloud at ``TARGET_TIME_4D``); then the
    overlay, VELOCITY, and VELOCITY with the overlay, whose boxes only the
    oracle draws (VELOCITY zeroes every opacity: ROADMAP Queue 3)."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, random_arrays_4d_seeded
    from bevy_gaussian_splatting_tpu_torch.models.settings import RasterizeMode
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode
    from bevy_gaussian_splatting_tpu_torch.render.api import render

    bg = torch.tensor([0.2, 0.1, 0.4, 1.0])
    mode = MODES[kernel_mode(settings)]
    a = random_arrays_4d_seeded(2000, seed=SEED_4D)
    s0 = settings.replace(time=TIME_4D)
    # the CPU's own spread: the same calls with every quaternion one ulp up.
    # The 4D covariance is diagonal in world axes (ROADMAP Queue 3), so in
    # OBB the footprint's axis is decided by rounding where its 2D
    # covariance is nearly diagonal; the card's products round otherwise
    # than the CPU's.  A bar card vs CPU is the larger of the fixed bar
    # and that spread (AABB has no axis: its spread stays far below)
    nudged = {k: v.copy() for k, v in a.items()}
    nudged["isotropic_rotations"] = np.nextafter(a["isotropic_rotations"], np.float32(np.inf))

    def cpu_image(arrays, cam, st):
        return render(cloud_from_numpy(arrays, "cpu"), cam, st, background=bg, device="cpu")

    def held(label, cam, st):
        # a gaussian at a mask threshold (the temporal marginal, the
        # frustum), decided one way on each device, changes the image by
        # its whole contribution: such a frame is held to the card's
        # oracle, which shares the card's mask, and the flip is counted
        flips, far = mask_flips(a, st, cam)
        if flips and far > MASK_FLIP_ULPS:
            raise AssertionError(f"4d mask card vs cpu ({label}): {flips} differ, up to {far:.1f} ulps from a "
                                 "threshold")
        if flips:
            log(f"[small {label}] {flips} gaussian(s) within {far:.1f} ulps of a mask threshold decided apart "
                "card vs cpu: held to the card's oracle only")
        spread = float((cpu_image(nudged, cam, st) - cpu_image(a, cam, st)).abs().max())
        return compare_small(f"{label} (cpu spread {spread:.3e})", a, cam, st, bg, oracle_only=bool(flips),
                             cpu_bar=max(IMAGE_BAR[mode], spread)), spread

    for width, height in ((128, 128), (128, 120)):
        cam = orbit_camera(0.0, width, height, "cpu")
        images = [held(f"4d {mode} time {t} {width}x{height}", cam, settings.replace(time=t))[0]
                  for t in (TIME_4D, 0.75)]
        moved = float((images[0] - images[1]).abs().max())
        if not moved > 0.1:
            raise AssertionError(f"4d {mode} {width}x{height}: the image does not move with the time ({moved:.3e})")
        label = f"4d {mode} {width}x{height}"
        g_cpu = small_grads(a, cam, bg, s0, "cpu", TARGET_TIME_4D)
        g_card = small_grads(a, cam, bg, s0, "cuda", TARGET_TIME_4D)
        g_spread = small_grads(nudged, cam, bg, s0, "cpu", TARGET_TIME_4D)
        bars = {k: max(GRAD_BAR, float((g_spread[k] - g_cpu[k]).abs().max()) / max(float(g_cpu[k].abs().max()), 1e-30))
                for k in g_cpu}
        rel = grads_rel(g_card, g_cpu, label, bars)
        log(f"[small {label}] image moved by {moved:.3e} between the times; gradients card vs cpu, max |diff| / "
            "max |cpu| per field: " + ", ".join(f"{k} {v:.3e} (bar {bars[k]:.3e})" for k, v in rel.items())
            + f"; a bar is the larger of {GRAD_BAR} and the CPU's own spread under a one-ulp quaternion change")
    cam = orbit_camera(0.0, 128, 120, "cpu")
    held(f"4d {mode} bbox 128x120", cam, s0.replace(visualize_bounding_box=True))
    velocity = s0.replace(rasterize_mode=RasterizeMode.VELOCITY)
    held(f"4d {mode} velocity 128x120", cam, velocity)
    vb = velocity.replace(visualize_bounding_box=True)
    tiled = render(cloud_from_numpy(a, "cuda"), cam.to("cuda"), vb, background=bg.cuda())
    cpu = cpu_image(a, cam, vb)
    oracle = render(cloud_from_numpy(a, "cuda"), cam.to("cuda"), vb, background=bg.cuda(), impl="oracle")
    spread = float((cpu_image(nudged, cam, vb) - cpu).abs().max())
    e_cpu = float((tiled.cpu() - cpu).abs().max())
    differ = int(((tiled - oracle).abs().amax(dim=-1) > 1e-3).sum())
    log(f"[small 4d {mode} velocity bbox 128x120] card vs cpu {e_cpu:.3e} (bar {max(IMAGE_BAR[mode], spread):.3e}, "
        f"cpu spread {spread:.3e}); pixels where the oracle and the tiled path differ by > 1e-3: {differ} of "
        f"{128 * 120}")
    if not e_cpu <= max(IMAGE_BAR[mode], spread):
        raise AssertionError(f"4d velocity overlay card vs cpu {e_cpu:.3e}")


def phase_main_4d(cloud, settings, profile: bool) -> tuple:
    """4DGS serving through ``render()`` at each size: the pair counts at
    ``PAIR_TIMES_4D`` and the budget of the worst, then a warm-up and
    ``FRAMES_4D`` frames at times 0.25 + 0.01 i, each through the expansion
    and the compositor's (mode, no overlay) instantiation and no backward
    kernel, finite and lit; then one VELOCITY frame and one overlay frame
    -> (launches of the mode's frames, launches of the overlay frames)."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import RasterizeMode
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.reduce import segment_reduce
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_bwd import composite_backward
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES, composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    mode = MODES[rt.kernel_mode(settings)]
    n = len(cloud)
    serve = {"expand_pairs": 0, "composite_tiles_raw": 0}
    overlay = {"expand_pairs": 0, "composite_tiles_raw": 0}
    for f in (composite_backward, segment_reduce):
        f.launches = 0

    def frame(s, bbox: bool, label: str, lit_floor: float = LIT_FLOOR):
        before = (expand_pairs.launches, composite_tiles_raw.instances.get((mode, bbox), 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = api.render(cloud, cam, s)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        after = (expand_pairs.launches, composite_tiles_raw.instances.get((mode, bbox), 0))
        if not all(x > y for x, y in zip(after, before)):
            raise AssertionError(f"{label}: a forward kernel did not launch")
        counts = serve if not bbox else overlay
        counts["expand_pairs"] += after[0] - before[0]
        counts["composite_tiles_raw"] += after[1] - before[1]
        lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
        if img.shape != (height, width, 4) or not bool(torch.isfinite(img).all()) or lit < lit_floor * width * height:
            raise AssertionError(f"bad image at {label} ({lit} lit pixels)")
        return dt, lit, [after[0] - before[0], after[1] - before[1]]

    for width, height in SIZES:
        label = f"4d {mode} {width}x{height}"
        cam = orbit_camera(0.0, width, height, cloud.device)
        counts = {t: int(rt.pair_count(cloud, cam, settings, time=t)) for t in PAIR_TIMES_4D}
        worst = max(counts.values())
        budget = rt.pairs_budget(n, worst)
        log(f"[main {label}] pairs at times {', '.join(f'{t} {c}' for t, c in counts.items())}; budget of the worst "
            f"{budget} (the cap at N {rt.pairs_budget(n)}), pairs past it (truncated, the farthest) {max(worst - budget, 0)}")
        frame(settings.replace(time=TIME_4D), False, f"{label} warm-up")
        times, per_frame = [], []
        for i in range(FRAMES_4D):
            dt, lit, launched = frame(settings.replace(time=TIME_4D + 0.01 * i), False, f"{label} frame {i}")
            times.append(dt)
            per_frame.append(launched)
        if composite_backward.launches or segment_reduce.launches:
            raise AssertionError(f"a backward kernel launched while serving at {label}")
        bucket = api._BUDGET_STATE[api.budget_key("auto", settings, width, height, cloud, cloud.device)][0]
        median = statistics.median(times)
        log(f"[main {label}] render() bucket {bucket} | median {median:.3f} ms/frame over {len(times)} frames at "
            f"times {TIME_4D}..{TIME_4D + 0.01 * (FRAMES_4D - 1):.2f} (min {min(times):.3f}, max {max(times):.3f}) | "
            f"lit {lit} | launches per frame (expand_pairs, composite_tiles_raw[{mode}, False]) "
            f"{sorted({tuple(c) for c in per_frame})}")
        if profile:
            profile_call(lambda: api.render(cloud, cam, settings.replace(time=TIME_4D + 0.05)),
                         f"4d_{mode}_{width}x{height}", median)
        # VELOCITY zeroes every opacity (ROADMAP Queue 3): no lit floor
        dt_v, lit_v, _ = frame(settings.replace(time=TIME_4D, rasterize_mode=RasterizeMode.VELOCITY), False,
                               f"{label} velocity", lit_floor=0.0)
        dt_b, lit_b, _ = frame(settings.replace(time=TIME_4D, visualize_bounding_box=True), True, f"{label} bbox")
        log(f"[main {label}] one VELOCITY frame {dt_v:.3f} ms, lit {lit_v}; one overlay frame {dt_b:.3f} ms, "
            f"lit {lit_b} (the first frame of each pipeline key, its pair count included)")
    return serve, overlay


def phase_train_4d(arrays: dict, settings, profile: bool) -> dict:
    """4DGS training through ``train_step`` on the 1M scene at
    ``TIME_4D`` towards a render of the same cloud at ``TARGET_TIME_4D``:
    per size a warm-up and ``TRAIN_STEPS_4D`` timed Adam steps, each through
    all four kernels with a finite loss and finite gradients."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.train.losses import mse
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, train_step

    mode = MODES[rt.kernel_mode(settings)]
    counters = train_counters()
    model = TrainableCloud.from_numpy(arrays, "cuda")
    optimizer = adam(model, TRAIN_LR)
    for f in counters:
        f.launches = 0
    s0 = settings.replace(time=TIME_4D)
    for width, height in SIZES:
        size = f"{width}x{height}"
        camera = orbit_camera(0.0, width, height, "cuda")
        with torch.no_grad():
            pairs = int(rt.pair_count(model.cloud(), camera, s0))
            p_max = rt.pairs_budget(len(model.cloud()), pairs)
            target = rt.render_tiled(model.cloud(), camera, s0, pairs_max=p_max, time=TARGET_TIME_4D)
        steps = [checked_step(model, optimizer, camera, target, s0, mse, p_max, f"4d {mode} {size} step {i}")
                 for i in range(TRAIN_STEPS_4D[(width, height)] + 1)]
        times = [dt for _, dt in steps[1:]]
        median = statistics.median(times)
        log(f"[train 4d {mode} {size}] pairs {pairs} p_max {p_max} truncated {max(pairs - p_max, 0)} | warm-up "
            f"{steps[0][1]:.3f} ms, median {median:.3f} ms/step over {len(times)} Adam steps (min {min(times):.3f}, "
            f"max {max(times):.3f}) | mse loss {steps[0][0]:.6e} -> {steps[-1][0]:.6e} | launches "
            + ", ".join(f"{f.__name__} {f.launches}" for f in counters))
        if profile:
            profile_call(lambda: train_step(model, optimizer, camera, target, s0, mse, pairs_max=p_max),
                         f"train_4d_{mode}_{size}", median)
    return {f.__name__: f.launches for f in counters}


def phase_flavours(arrays: dict) -> dict:
    """The other cloud flavours on the 1M bench scene (OBB), served through
    ``render()``: the precomputed covariance against the quaternion and
    scale render (``COV_BAR``), f16 and bf16 storage against the float32
    render of the rounded cloud (``HALF_BAR``), SH degree-4 storage against
    degree 3 (``SH4_BAR``); a warm-up and ``FLAVOUR_FRAMES`` timed frames
    each, every one through both forward kernels -> their launches."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import (
        cloud_from_numpy,
        precompute_covariance_3d,
        set_sh_degree,
    )
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    settings = CloudSettings()
    base = cloud_from_numpy(arrays, "cuda")
    f16, bf16 = base.astype(torch.float16), base.astype(torch.bfloat16)
    flavours = (
        ("precompute_covariance_3d", precompute_covariance_3d(base), base, "the quaternion and scale render", COV_BAR),
        ("f16 storage", f16, f16.astype(torch.float32), "the float32 render of the rounded cloud", HALF_BAR),
        ("bf16 storage", bf16, bf16.astype(torch.float32), "the float32 render of the rounded cloud", HALF_BAR),
        ("sh degree 4", set_sh_degree(base, 4), base, "the degree-3 render", SH4_BAR),
    )
    launches = {"expand_pairs": 0, "composite_tiles_raw": 0}

    def counts():
        return expand_pairs.launches, composite_tiles_raw.instances.get(("obb", False), 0)

    for width, height in SIZES:
        cam = orbit_camera(0.0, width, height, "cuda")
        for name, cloud, ref_cloud, ref_name, bar in flavours:
            ref = api.render(ref_cloud, cam, settings)
            times = []
            for i in range(FLAVOUR_FRAMES + 1):  # frame 0 warms up
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = api.render(cloud, cam, settings)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
                after = counts()
                if not all(a > b for a, b in zip(after, before)):
                    raise AssertionError(f"{name} {width}x{height}: a forward kernel did not launch")
                launches["expand_pairs"] += after[0] - before[0]
                launches["composite_tiles_raw"] += after[1] - before[1]
            err = float((img - ref).abs().max())
            lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
            log(f"[flavours {name} {width}x{height}] vs {ref_name} {err:.3e} (bar {bar}) | median "
                f"{statistics.median(times):.3f} ms/frame over {len(times)} frames | lit {lit}")
            if not (err <= bar and bool(torch.isfinite(img).all()) and lit >= LIT_FLOOR * width * height):
                raise AssertionError(f"flavour {name} {width}x{height}: {err:.3e} against {ref_name}, {lit} lit")
    return launches


def orbit_host_camera(az: float, el: float, width: int, height: int, device):
    """The host-built camera of an orbit pose at radius 60 about the origin."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.render.api import orbit_eye

    return Camera.create(eye=orbit_eye(az, el, SERVE_RADIUS), target=(0.0, 0.0, 0.0), width=width, height=height,
                         device=device)


def serve_counts(instance) -> tuple:
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw

    return expand_pairs.launches, composite_tiles_raw.instances.get(instance, 0)


def served(fn, instance, expands: int, label: str):
    """``fn()`` ending in a synchronise -> (image, wall ms); raises unless it
    launched the expansion ``expands`` times and the compositor's
    ``instance`` once."""
    before = serve_counts(instance)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = fn()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    after = serve_counts(instance)
    got = (after[0] - before[0], after[1] - before[1])
    if got != (expands, 1):
        raise AssertionError(f"{label}: launched (expand_pairs, composite_tiles_raw{list(instance)}) {got}, "
                             f"expected ({expands}, 1)")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite image")
    return img, dt


def phase_serve(cloud, settings) -> dict:
    """Frame-coherent serving at 512x512, the JAX bench's replay protocol
    (bench.py:246-300): ``InteractiveRenderer(period_floor_ms=1e9)``,
    ``render_orbit`` at el 0.2 and radius 60, a sub-threshold move, then
    ``SERVE_WINDOWS`` windows of ``SERVE_FRAMES`` orbit frames; one bin, and
    replay frames with no expansion.  Then the host-camera frame against
    ``render(impl="tiled")``, the replay pipeline's bin and replay, the
    renderer's bin frame, replay frame and ``render()``, timed in turns, and
    the device time of a replay frame -> launches."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import orbit_camera_device
    from bevy_gaussian_splatting_tpu_torch.models.settings import GaussianMode
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.reduce import segment_reduce
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_bwd import composite_backward
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES, composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    width, height = SIZES[0]
    mode = MODES[rt.kernel_mode(settings)]
    label = f"serve {mode} {width}x{height}"
    instance = (mode, False)
    el = SERVE_EL

    def orbit(r, az):
        return lambda: r.render_orbit(cloud, az, el, SERVE_RADIUS, width=width, height=height)

    r = api.InteractiveRenderer(settings, period_floor_ms=1e9)
    for f in (composite_backward, segment_reduce):
        f.launches = 0
    expand_pairs.launches = 0
    composite_tiles_raw.instances.clear()
    served(orbit(r, 0.0), instance, 1, f"{label} bin frame")
    moved, _ = served(orbit(r, 1e-5), instance, 0, f"{label} sub-threshold move")
    # a fresh render() at the same orbit camera (one built on the host moves
    # rounding-decided splat edges: tests/test_interactive.py:168-169)
    orbit_cam = orbit_camera_device(
        torch.tensor([1e-5, el, SERVE_RADIUS, 0.0, 0.0, 0.0], device=cloud.device), width, height
    )
    fresh = api.render(cloud, orbit_cam, settings, impl="tiled")
    d_stale = (moved - fresh).abs()
    # the fresh frames' own change under the move: on the 1M scene
    # near-tied depths swap.  The stale frame may differ from the fresh one
    # in no more pixels past the bar than the fresh frames do, and, in OBB
    # and AABB, by at most their change plus the bar at each pixel.  A 2DGS
    # surfel's extent comes by cancellation (gaussian_2d.py): its falloff
    # at a pixel may change by far more than the move, in a pixel whose
    # tile the stale bins hold and the fresh ones do not, or the reverse
    orbit_cam0 = orbit_camera_device(torch.tensor([0.0, el, SERVE_RADIUS, 0.0, 0.0, 0.0], device=cloud.device),
                                     width, height)
    d_fresh = (api.render(cloud, orbit_cam0, settings, impl="tiled") - fresh).abs()
    e_moved, e_fresh = float(d_stale.max()), float(d_fresh.max())
    e_excess = float((d_stale - d_fresh).max())
    n_stale = int((d_stale.amax(dim=-1) > SERVE_STALE_BAR).sum())
    n_fresh = int((d_fresh.amax(dim=-1) > SERVE_STALE_BAR).sum())
    n_excess = int(((d_stale - d_fresh).amax(dim=-1) > SERVE_STALE_BAR).sum())
    per_pixel = settings.gaussian_mode != GaussianMode.GAUSSIAN_2D
    stale_ok = n_stale <= n_fresh and (e_excess <= SERVE_STALE_BAR or not per_pixel)
    again, _ = served(orbit(r, 1e-5), instance, 0, f"{label} unchanged pose")
    replay_bitwise = bool(torch.equal(again, moved))
    window_ms = []
    for w in range(SERVE_WINDOWS):
        t0 = time.perf_counter()
        for i in range(SERVE_FRAMES):
            az = 2.0 * math.pi * (i + 1) / SERVE_FRAMES + w * 1e-3
            img, _ = served(orbit(r, az), instance, 0, f"{label} window {w} frame {i}")
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - t0) * 1e3 / SERVE_FRAMES)
    stats = dict(r.stats)
    lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
    log(f"[{label}] render_orbit el {el} radius {SERVE_RADIUS}: stats {stats}; sub-threshold move (az 1e-5) vs a "
        f"fresh render() at its camera {e_moved:.3e}, fresh frames at az 0 and 1e-5 {e_fresh:.3e}; stale past the "
        f"fresh frames' change by at most {e_excess:.3e} at a pixel, past {SERVE_STALE_BAR} in {n_excess} pixels (bar "
        f"{SERVE_STALE_BAR if per_pixel else 'none: 2DGS'}); pixels past "
        f"{SERVE_STALE_BAR}: stale {n_stale}, fresh frames {n_fresh} (bar: no more); replay at an unchanged pose bitwise "
        f"{replay_bitwise}; {SERVE_WINDOWS} windows of {SERVE_FRAMES} orbit frames: "
        + ", ".join(f"{t:.3f}" for t in window_ms) + f" ms/frame (the JAX bench's replay_ms: the best); lit {lit}")
    if stats["bins"] != 1 or stats["oneshots"] != 0:
        raise AssertionError(f"{label}: {stats}, expected one bin across the orbit")
    if not stale_ok or not replay_bitwise:
        raise AssertionError(f"{label}: stale frame {e_excess:.3e} past the fresh frames' change, {n_stale} pixels "
                             f"past {SERVE_STALE_BAR} against {n_fresh}; replay bitwise {replay_bitwise}")
    if lit < LIT_FLOOR * width * height:
        raise AssertionError(f"{label}: only {lit} lit pixels")
    launches = {"expand_pairs": expand_pairs.launches, "composite_tiles_raw": composite_tiles_raw.instances[instance]}
    if composite_backward.launches or segment_reduce.launches:
        raise AssertionError(f"{label}: a backward kernel launched while serving")

    # a host camera: InteractiveRenderer.render against render(impl="tiled")
    cam = orbit_host_camera(0.3, el, width, height, cloud.device)
    host = api.InteractiveRenderer(settings, period_floor_ms=1e9).render(cloud, cam)
    tiled = api.render(cloud, cam, settings, impl="tiled")
    e_host = float((host - tiled).abs().max())
    bucket = api._BUDGET_STATE[api.budget_key("tiled", settings, width, height, cloud, cloud.device)][0]

    # the replay pipeline alone: bins at one pose, a replay at another
    cam0, cam1 = (orbit_host_camera(az, el, width, height, cloud.device) for az in (0.0, 0.05))
    bin_fn, replay_fn = api.make_replay_pipeline(settings, width, height, bucket)[:2]
    bins = bin_fn(cloud, cam0)
    bg0 = torch.zeros(4, device=cloud.device)
    rows = int(bins[0].shape[0])
    # timed in turns: the pipeline's bin and replay, then the renderer's bin
    # frame, replay frame and render()
    times = {k: [] for k in ("bin", "replay")}
    for _ in range(SERVE_TURNS):
        times["bin"].append(wall_ms(lambda: bin_fn(cloud, cam0)))
        times["replay"].append(wall_ms(lambda: replay_fn(cloud, cam1, None, bg0, 0.0, *bins)))
    frame_times = {k: [] for k in ("bin frame", "replay frame", "render()")}
    for i in range(SERVE_TURNS):
        az = 0.7 + 0.01 * i
        r.period_ms = 0.0  # the next move bins
        frame_times["bin frame"].append(served(orbit(r, az), instance, 1, f"{label} timed bin frame")[1])
        frame_times["replay frame"].append(served(orbit(r, az + 0.005), instance, 0, f"{label} timed replay")[1])
        cam = orbit_host_camera(az, el, width, height, cloud.device)
        frame_times["render()"].append(served(lambda: api.render(cloud, cam, settings), instance, 1,
                                              f"{label} timed render()")[1])
    med = {k: statistics.median(v) for k, v in {**times, **frame_times}.items()}
    log(f"[{label}] renderer.render at a host camera vs render(impl='tiled') {e_host:.3e} (bar {SERVE_HOST_BAR}), "
        f"bitwise {e_host == 0.0}; the JAX package's pair-order replay (not ported) would gather {rows} cloud rows, "
        f"{rows * cloud_row_bytes(cloud)} bytes")
    log(f"[{label}] medians over {SERVE_TURNS} turns, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    if e_host > SERVE_HOST_BAR:
        raise AssertionError(f"{label}: host-camera frame {e_host:.3e} from render(impl='tiled')")
    r.period_ms = 1e9
    profile_call(orbit(r, 0.75), f"replay_{mode}_{width}x{height}", med["replay frame"])
    return launches


def cloud_row_bytes(cloud) -> int:
    """Bytes of one row of every field of a cloud."""
    return sum(getattr(cloud, f.name)[0].numel() * getattr(cloud, f.name).element_size()
               for f in dataclasses.fields(cloud))


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_orbit_keys(cloud) -> None:
    """Radix keys from an orbit camera built on the card against the same
    camera built on the CPU, on the 1M scene; and a small ``render_orbit``
    card against CPU at the JAX test's bars (tests/test_interactive.py:
    168-169: mean |diff| < 1e-3, more than 99.5% of pixels within 1e-2)."""
    from bevy_gaussian_splatting_tpu_torch.models.camera import orbit_camera_device
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.ops.sort import radix_depth_key
    from bevy_gaussian_splatting_tpu_torch.render import api

    width, height = SIZES[0]
    orbit = torch.tensor([0.3, SERVE_EL, SERVE_RADIUS, 0.0, 0.0, 0.0], dtype=torch.float32)
    cams = {dev: orbit_camera_device(orbit.to(dev), width, height) for dev in ("cuda", "cpu")}
    e_cam = max(float((getattr(cams["cuda"], f).cpu() - getattr(cams["cpu"], f)).abs().max())
                for f in ("view_from_world", "prev_clip_from_world", "world_position"))
    position = cloud.position
    keys = {}
    for dev, cam in cams.items():
        pos = position.to(dev)
        keys[dev] = radix_depth_key(pos, torch.eye(4, device=pos.device), cam.clip_from_world,
                                    cam.world_position).cpu()
    differ = int((keys["cuda"] != keys["cpu"]).sum())
    host = orbit_host_camera(0.3, SERVE_EL, width, height, cloud.device)
    host_keys = radix_depth_key(position, torch.eye(4, device=cloud.device), host.clip_from_world, host.world_position)
    differ_host = int((host_keys.cpu() != keys["cuda"]).sum())
    a = bench_arrays(2000, seed=3)
    imgs = {dev: api.InteractiveRenderer(device=dev).render_orbit(cloud_from_numpy(a, dev), 0.3, SERVE_EL,
                                                                  SERVE_RADIUS, width=128, height=128).cpu()
            for dev in ("cuda", "cpu")}
    diff = (imgs["cuda"] - imgs["cpu"]).abs()
    mean, within = float(diff.mean()), float((diff < 1e-2).double().mean())
    log(f"[orbit keys {width}x{height}] orbit camera card vs cpu, largest matrix difference {e_cam:.3e}; radix keys "
        f"that differ card vs cpu {differ} of {len(keys['cpu'])} (against the host-built camera on the card "
        f"{differ_host}); render_orbit bench2000 128x128 card vs cpu: max {float(diff.max()):.3e}, mean "
        f"{mean:.3e} (bar 1e-3), share within 1e-2 {within:.6f} (bar 0.995)")
    if not (mean < 1e-3 and within > 0.995):
        raise AssertionError("render_orbit card vs cpu past the JAX test's bars")


def phase_project(cloud, cloud4) -> None:
    """The fused serving projection (``ops/cuda/project.py``) on the 1M
    scenes, 3D and the 3D scene as 2DGS surfels at 1280x720, 4D at 512x512:
    its outputs against its plain version (the eager chain and the packing)
    bit for bit, both timed by CUDA events (a call: the ``clip_from_world``
    product and the kernel), and the bound by the bytes the kernel must
    move."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj
    from bevy_gaussian_splatting_tpu_torch.utils import trace

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    cases = (("3d", cloud, CloudSettings(), 1280, 720),
             ("2d", cloud, CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D), 1280, 720),
             ("4d", cloud4, CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, time=TIME_4D), 512, 512))
    for label, c, settings, width, height in cases:
        cam = orbit_camera(0.3, width, height, "cuda")
        before = trace.counters().get("project.fused", 0)
        got = pj.project_splats(c, cam, settings)
        if trace.counters().get("project.fused", 0) != before + 1:
            raise AssertionError(f"fused projection {label}: project_splats launched no kernel")
        ref = pj.project_splats_plain(c, cam, settings)
        differ = [k for k in ref if not torch.equal(bits(got[k]), bits(ref[k]))]
        if differ:
            raise AssertionError(f"fused projection {label}: {differ} differ from the eager chain")
        read = sum(getattr(c, f.name).numel() * 4 for f in dataclasses.fields(c))
        written = sum(t.numel() * t.element_size() for t in got.values())
        t_bound, _ = bound(read + written, 0.0, 1.0)
        kernel = cuda_ms(lambda: pj.project_splats(c, cam, settings), 20)
        plain = cuda_ms(lambda: pj.project_splats_plain(c, cam, settings), 5)
        log(f"[kernels project {label} {width}x{height}] {len(c)} gaussians, {read / len(c):.0f} B read and "
            f"{written / len(c):.0f} B written a gaussian | kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
            f"bound {t_bound:.4f} ms (bytes, {100.0 * t_bound / kernel:.1f}%) | bitwise equal | "
            f"{card_name_and_limit()}")


def sh_stage_inputs(c, cam, time: float) -> list:
    """The colour stage's inputs as ``project_gaussians`` makes them for
    ``c`` seen by ``cam`` (identity model transform; 4D: the unshifted
    positions, dir_t = time - timestamp)."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian4dCloud
    from bevy_gaussian_splatting_tpu_torch.ops import sh as sh_ops
    from bevy_gaussian_splatting_tpu_torch.ops import sort as sort_ops

    diff = c.position - cam.world_position
    dist2 = sort_ops.squared_distance(diff)
    ray = diff / torch.clamp(torch.sqrt(dist2)[..., None], min=1e-12)
    direction = sh_ops.world_to_local_direction(ray, torch.eye(4, device="cuda"))
    if not isinstance(c, Gaussian4dCloud):
        return [direction, c.spherical_harmonic.contiguous(), None, None]
    dir_t = torch.full((), time, dtype=torch.float32, device="cuda") - c.timestamp
    return [direction, c.spherindrical_harmonic.contiguous(), dir_t, torch.full((), 1.0, device="cuda")]


def phase_sh(cloud, cloud4) -> None:
    """The training colour stage's kernels (``ops/cuda/sh.py``) on the 1M
    scenes, 3D at 1280x720 and 4D at 512x512: the forward's colour bitwise
    the eager chain's, the backward's d_sh bitwise autograd's; each kernel
    timed by CUDA events against the least time of its bytes (each input
    byte read and each output byte written once), and the plain version
    (the eager chain's forward and autograd backward) beside them."""
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import sh as sh_fn

    for label, c, width, height in (("3d", cloud, 1280, 720), ("4d", cloud4, 512, 512)):
        cam = orbit_camera(0.3, width, height, "cuda")
        args = sh_stage_inputs(c, cam, TIME_4D)
        n, w = args[1].shape
        g = torch.randn((n, 3), generator=torch.Generator("cuda").manual_seed(5), device="cuda")
        leaves = [t.detach().requires_grad_() if t is not None else None for t in args[:3]] + [args[3]]
        eager = sh_fn.sh_colour_plain(*leaves)
        want = torch.autograd.grad(eager, leaves[1], g)[0]
        rgb = sh_fn.sh_colour_forward_kernel(*args)
        got = sh_fn.sh_colour_backward_kernel(*args, g)
        if not (same_bits(rgb, eager.detach()) and same_bits(got[1], want)):
            raise AssertionError(f"sh {label}: the kernels' colour or d_sh differ from the eager chain's")
        # d_dir (and 4D d_dir_t) against float64 autograd through the eager chain
        wide = [t.detach().double().requires_grad_() if t is not None else None for t in args[:3]]
        wide.append(None if args[3] is None else args[3].double())
        wrt = [wide[0]] + ([wide[2]] if args[2] is not None else [])
        exact = torch.autograd.grad(sh_fn.sh_colour_plain(*wide), wrt, g.double())
        gaps = {"d_dir": rel_gap(got[0], exact[0])}
        if args[2] is not None:
            gaps["d_dir_t"] = rel_gap(got[2], exact[1])
        del wide, exact
        if not all(math.isfinite(v) and v <= SH_GRAD_BAR for v in gaps.values()):
            raise AssertionError(f"sh {label}: the backward kernel's {gaps} against float64 autograd, bar {SH_GRAD_BAR}")
        extra = 0 if args[2] is None else 4  # dir_t
        fwd_bytes = n * (w * 4 + 12 + extra + 12)
        bwd_bytes = n * (2 * w * 4 + 12 + 12 + 2 * extra + 12)
        fwd_bound, _ = bound(fwd_bytes, 0.0, 1.0)
        bwd_bound, _ = bound(bwd_bytes, 0.0, 1.0)
        fwd = cuda_ms(lambda: sh_fn.sh_colour_forward_kernel(*args), 20)
        bwd = cuda_ms(lambda: sh_fn.sh_colour_backward_kernel(*args, g), 20)

        def plain():
            out = sh_fn.sh_colour_plain(*leaves)
            torch.autograd.grad(out, [t for t in leaves[:3] if t is not None], g)

        plain_ms = cuda_ms(plain, 3)
        log(f"[kernels sh {label} {width}x{height}] {n} gaussians, rows of {w} floats | forward {fwd:.4f} ms, "
            f"bound {fwd_bound:.4f} ms ({100.0 * fwd_bound / fwd:.1f}%) | backward {bwd:.4f} ms, bound "
            f"{bwd_bound:.4f} ms ({100.0 * bwd_bound / bwd:.1f}%) | plain (eager chain and autograd) "
            f"{plain_ms:.4f} ms | colour and d_sh bitwise, {', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} of "
            f"float64 autograd | {card_name_and_limit()}")


def phase_project_train(cloud) -> None:
    """The 3DGS training projection (``ops/cuda/project.py`` ``ProjectCore``)
    on the 1M scene at 512x512, OBB and AABB: the forward kernel's outputs
    against the eager chain's bit for bit, the backward kernel's leaf
    gradients against its twin (``project_backward_plain``) within
    PROJECT_TWIN_BAR, each kernel alone timed by CUDA events against the
    least time of its bytes (each input byte read and each output byte
    written once; the cotangent's packed rows read whole), and the eager
    chain with its autograd beside them; ptxas's registers and spills."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import project as pj

    usage = {k: v for k, v in build.ptxas_usage("project") if "train" in k or "bwd" in k}
    cam = orbit_camera(0.3, 512, 512, "cuda")
    leaves = [getattr(cloud, k).detach() for k in ("position_visibility", "rotation", "scale_opacity")]
    n = len(cloud)
    rows = torch.randn((n, 10), generator=torch.Generator("cuda").manual_seed(5), device="cuda")
    g_dir = torch.randn((n, 3), generator=torch.Generator("cuda").manual_seed(6), device="cuda")
    for label, settings in (("obb", CloudSettings()), ("aabb", CloudSettings(aabb=True))):
        args = (cam, settings, None, 512, 512)
        geom, alpha, direction, fields = pj._train_kernel(*leaves, *args)
        ref = pj.project_splats_plain(cloud, cam, settings, size=(512, 512))
        got = dict(fields, params=torch.cat([geom, ref["params"][:, 6:9], alpha], dim=1))
        differ = [k for k in ref if not same_bits(got[k], ref[k])]
        if differ:
            raise AssertionError(f"project train {label}: {differ} differ from the eager chain")
        mask = fields["mask"]
        bwd_args = (mask, rows[:, :6], rows[:, 9:], g_dir, *args)
        grads = pj._backward_kernel(*leaves, *bwd_args)
        twin = pj.project_backward_plain(*leaves, *bwd_args)
        finite = torch.isfinite(ref["params"]).all(dim=1)
        gaps = {k: rel_gap(a[finite], b[finite]) for k, a, b in zip(("pos", "rot", "scale_op"), grads, twin)}
        del twin
        if not all(math.isfinite(v) and v <= PROJECT_TWIN_BAR for v in gaps.values()):
            raise AssertionError(f"project train {label}: the backward kernel's {gaps} against its twin")
        written = sum(t.numel() * t.element_size() for t in (geom, alpha, direction, *fields.values()))
        fwd_bound, _ = bound(n * 48 + written, 0.0, 1.0)
        bwd_bound, _ = bound(n * (48 + 1 + 40 + 12 + 48), 0.0, 1.0)
        fwd = cuda_ms(lambda: pj._train_kernel(*leaves, *args), 20)
        bwd = cuda_ms(lambda: pj._backward_kernel(*leaves, *bwd_args), 20)
        wide = [t.requires_grad_() for t in (t.clone() for t in leaves)]

        def plain():
            c = dataclasses.replace(cloud, position_visibility=wide[0], rotation=wide[1], scale_opacity=wide[2])
            out = pj.project_splats_plain(c, cam, settings, size=(512, 512))["params"]
            torch.autograd.grad((out * rows).sum(), wide)

        plain_ms = cuda_ms(plain, 3)
        log(f"[kernels project train {label} 512x512] {n} gaussians | forward {fwd:.4f} ms, bound {fwd_bound:.4f} ms "
            f"({100.0 * fwd_bound / fwd:.1f}%, {(n * 48 + written) / n:.0f} B a gaussian) | backward {bwd:.4f} ms, "
            f"bound {bwd_bound:.4f} ms ({100.0 * bwd_bound / bwd:.1f}%, 149 B a gaussian) | plain (eager chain "
            f"and autograd) {plain_ms:.4f} ms | forward bitwise, backward "
            f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} of its twin | {card_name_and_limit()}")
    for kernel, line in usage.items():
        log(f"[kernels project train] ptxas {kernel}: {line}")


def phase_surface(arrays: dict) -> None:
    """2DGS training with the surface maps (``train_step(...,
    surface_loss=SurfaceLoss())``, the cell ``gs2d-1m.train-512``'s path)
    on the 1M scene at 512x512: one step with the kernels' launch counters
    zeroed just before it must launch the expansion, the surface forward
    ``<2, false, true>``, the backward and the 23-column reduce once each
    and count one ``geometry.steps``.  The three calls' inputs in that step
    (``ops/cuda/core.py``'s, recorded) then hold each kernel to its plain
    twin: the forward's colour and transmittance within IMAGE_BAR and bit
    for bit the serving instantiation's on the first 16 columns, its maps
    and totals within SURFACE_MAP_BAR of each map's norm (the distortion
    SURFACE_DIST_BAR) and the median's fragment the same at all but
    SURFACE_MEDIAN_SHARE of the pixels; the backward per column within
    GRAD_BAR of its largest |plain| at the step's own cotangents, the radius
    column exactly 0; the reduce bit for bit.  Each is timed by CUDA events
    against its plain twin and its least time (bytes; operations without
    the maps' per-fragment work, so a lower bound), beside the serving
    instantiations on the same rows."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import core
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_bwd as tb
    from bevy_gaussian_splatting_tpu_torch.ops.cuda import tile_fwd as tf
    from bevy_gaussian_splatting_tpu_torch.train.losses import SurfaceLoss, mse
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, shifted_arrays, train_step
    from bevy_gaussian_splatting_tpu_torch.utils import trace

    settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D)
    width, height = SIZES[0]
    size = f"{width}x{height}"
    model = TrainableCloud.from_numpy(arrays, "cuda")
    optimizer = adam(model, TRAIN_LR)
    camera, p_max, pairs, target = train_target(model, cloud_from_numpy(shifted_arrays(arrays), "cuda"), settings,
                                                width, height)
    # a warm-up step, outside the counted one
    train_step(model, optimizer, camera, target, settings, mse, pairs_max=p_max, surface_loss=SurfaceLoss())

    # the checked step: counters zeroed, the three calls' inputs recorded
    calls = ("composite_tiles_raw", "composite_backward", "segment_reduce")
    real = {name: getattr(core, name) for name in calls}
    seen = {}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name] = (args, kwargs)
            return real[name](*args, **kwargs)
        return call

    counters = train_counters()
    for f in counters:
        f.launches = 0
    key = ("2d", False, "surface")
    surface_before = tf.composite_tiles_raw.instances.get(key, 0)
    geometry_before = trace.counters().get("geometry.steps", 0)
    for name in calls:
        setattr(core, name, recorder(name))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(model, optimizer, camera, target, settings, mse, pairs_max=p_max, surface_loss=SurfaceLoss())
        value = float(loss)
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in real.items():
            setattr(core, name, fn)
    launches = {f.__name__: f.launches for f in counters}
    surface_launches = tf.composite_tiles_raw.instances.get(key, 0) - surface_before
    geometry_steps = trace.counters().get("geometry.steps", 0) - geometry_before
    if set(launches.values()) != {1} or surface_launches != 1 or geometry_steps != 1:
        raise AssertionError(f"surface {size}: the step launched {launches}, the surface forward "
                             f"{surface_launches} times, geometry.steps {geometry_steps} (each must be 1)")
    bad = [name for name in model.fields if not bool(torch.isfinite(getattr(model, name).grad).all())]
    if not math.isfinite(value) or bad:
        raise AssertionError(f"surface {size}: loss {value}, non-finite gradients in {bad}")
    log(f"[train 2d surface {size}] pairs {pairs} p_max {p_max} | one step {step_ms:.3f} ms, loss {value:.6e} | "
        f"launches {', '.join(f'{k} {v}' for k, v in launches.items())}, of them the surface forward "
        f"{surface_launches}; geometry.steps {geometry_steps}")

    # the forward on the step's rows against its twin and the serving instantiation
    (rows, start, count, tx_count, w, full_h, y0, chunk, kmode, bbox), fkw = seen["composite_tiles_raw"]
    near = fkw["aux_near"]
    geo = (tx_count, w, full_h, y0, chunk, kmode)
    fwd = lambda: tf.composite_tiles_raw(rows, start, count, *geo, aux_near=near)  # noqa: E731
    raw, maps, totals = fwd()
    again = fwd()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip((raw, maps, totals), again)):
        raise AssertionError(f"surface forward {size}: two launches on the same inputs differ")
    del again
    rows16 = rows[:, :16].contiguous()
    serve = lambda: tf.composite_tiles_raw(rows16, start, count, *geo)  # noqa: E731
    if not torch.equal(raw.view(torch.int32), serve().view(torch.int32)):
        raise AssertionError(f"surface forward {size}: colour and transmittance differ from the serving <2, false>")
    walked = torch.zeros(start.shape[0], dtype=torch.int64, device=rows.device)
    inside = torch.zeros_like(walked)
    p_raw, p_maps, p_totals = tf.composite_tiles_raw_plain(rows, start, count, *geo, tile_batch=512, walked=walked,
                                                           inside_count=inside, aux_near=near)
    raw_err = float((raw - p_raw).abs().max())
    gaps = {name: rel_gap(maps[:, k], p_maps[:, k]) for k, name in enumerate(("N.x", "N.y", "N.z", "D", "dist"))}
    gaps.update({f"totals{k}": rel_gap(totals[:, k], p_totals[:, k]) for k in range(3)})
    median_share = max(float((maps[:, 5] != p_maps[:, 5]).float().mean()),
                       float((totals[:, 3] != p_totals[:, 3]).float().mean()))
    bars = {name: SURFACE_DIST_BAR if name == "dist" else SURFACE_MAP_BAR for name in gaps}
    if (not raw_err <= IMAGE_BAR["2d"] or not all(gaps[k] <= bars[k] for k in gaps)
            or not median_share <= SURFACE_MEDIAN_SHARE):
        raise AssertionError(f"surface forward {size}: raw {raw_err:.3e} (bar {IMAGE_BAR['2d']}), maps "
                             f"{gaps} (bars {bars}), median fragment differs at {median_share:.2e} of the pixels "
                             f"(bar {SURFACE_MEDIAN_SHARE})")
    del p_raw, p_maps, p_totals
    n_walked, n_inside = int(walked.sum()), int(inside.sum())
    num_tiles = start.shape[0]
    fwd_bytes = n_walked * rows.shape[1] * 4 + 2 * 4 * num_tiles + (raw.numel() + maps.numel() + totals.numel()) * 4
    fwd_bound, fwd_by = bound(fwd_bytes, n_walked * STAGE_OPS_PER_PAIR["2d"]
                              + n_inside * (COMPOSITE_OPS_PER_INSIDE["2d"] + 1), FP32_NO_FMA_OPS_PER_S)
    fwd_ms = cuda_ms(fwd, 20)
    serve_ms = cuda_ms(serve, 20)
    fwd_plain_ms = cuda_ms(lambda: tf.composite_tiles_raw_plain(rows, start, count, *geo, tile_batch=512,
                                                                aux_near=near), 2)
    log(f"[kernels 2d surface {size}] forward <2, false, true>: raw max_abs_err {raw_err:.3e} (bar "
        f"{IMAGE_BAR['2d']}), colour and transmittance bitwise the serving <2, false>, maps |kernel - plain| / "
        f"|plain| {', '.join(f'{k} {v:.2e}' for k, v in gaps.items())} (bars {SURFACE_MAP_BAR}, dist "
        f"{SURFACE_DIST_BAR}), median fragment differs at {median_share:.2e} of the pixels, bitwise equal twice | "
        f"{fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}, bound {fwd_bound:.4f} by {fwd_by}, "
        f"{100.0 * fwd_bound / fwd_ms:.1f}%; serving <2, false> on the first 16 columns {serve_ms:.4f}) | pairs "
        f"walked {n_walked}, (pair, pixel) inside {n_inside} | {card_name_and_limit()}")

    # the backward at the step's own cotangents
    (b_rows, b_start, b_count, gbar, *b_geo), bkw = seen["composite_backward"]
    gaux = bkw["gaux"]
    bwd = lambda: tb.composite_backward(b_rows, b_start, b_count, gbar, *b_geo, gaux=gaux, aux_near=near)  # noqa: E731
    got = bwd()
    if not torch.equal(got, bwd()):
        raise AssertionError(f"surface backward {size}: two launches on the same inputs differ")
    plain = tb.composite_backward_plain(b_rows, b_start, b_count, gbar, *b_geo, tile_batch=512, gaux=gaux,
                                        aux_near=near)
    if got.shape[1] != 23 or bool(got[:, 2].any()) or bool(plain[:, 2].any()):
        raise AssertionError(f"surface backward {size}: {got.shape[1]} columns, or the radius column has a gradient")
    col_max = plain.abs().amax(dim=0)
    col_rel = ((got - plain).abs().amax(dim=0) / col_max.clamp(min=1e-30)).tolist()
    if not all(r <= GRAD_BAR for r in col_rel):
        raise AssertionError(f"surface backward {size}: per-column |kernel - plain| / max|plain| "
                             f"{[f'{r:.2e}' for r in col_rel]} above {GRAD_BAR}")
    del plain
    bwd_bytes = (n_walked * b_rows.shape[1] * 4 + 2 * 4 * num_tiles + (gbar.numel() + gaux.numel()) * 4
                 + got.numel() * 4)
    bwd_bound, bwd_by = bound(bwd_bytes, n_walked * STAGE_OPS_PER_PAIR["2d"]
                              + n_inside * (BACKWARD_OPS_PER_INSIDE["2d"] + 1), FP32_NO_FMA_OPS_PER_S)
    bwd_ms = cuda_ms(bwd, 10)
    serve_bwd_ms = cuda_ms(lambda: tb.composite_backward(rows16, b_start, b_count, gbar, *b_geo), 10)
    bwd_plain_ms = cuda_ms(lambda: tb.composite_backward_plain(b_rows, b_start, b_count, gbar, *b_geo, tile_batch=512,
                                                               gaux=gaux, aux_near=near), 1)
    log(f"[kernels 2d surface {size}] backward <2, true>: per-column |kernel - plain| / max|plain| "
        f"{' '.join(f'{r:.2e}' for r in col_rel)} (bar {GRAD_BAR}) at the step's cotangents, bitwise equal twice | "
        f"{bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}, bound {bwd_bound:.4f} by {bwd_by}, "
        f"{100.0 * bwd_bound / bwd_ms:.1f}%; <2> on the first 16 columns {serve_bwd_ms:.4f}) | {card_name_and_limit()}")

    # the 23-column reduce on the step's slot rows
    (dslot, cum, n), _ = seen["segment_reduce"]
    entry, line = reduce_case(dslot, cum, n, f"2d surface {size}", 20)
    log(f"[kernels 2d surface {size}] reduce <23>: {line} ({100.0 * entry['bound_ms'] / entry['ms']:.1f}%) | "
        f"{card_name_and_limit()}")
    log("[surface] " + json.dumps({
        "forward": {"ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "serving_ms": serve_ms},
        "backward": {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound, "serving_ms": serve_bwd_ms},
        "reduce": {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "launches": {**launches, "surface_forward": surface_launches}}))


def phase_serve_4d(cloud, settings) -> dict:
    """4DGS serving (bench.py:370-394): a time sweep of ``render_orbit``
    renders every frame in one pass (``oneshots``), each through the
    expansion and the compositor; a settled time then bins once and its
    replays are bitwise the one-pass frame -> launches."""
    from bevy_gaussian_splatting_tpu_torch.ops import rasterize_tile as rt
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES, composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.render import api

    width, height = SIZES[0]
    mode = MODES[rt.kernel_mode(settings)]
    instance = (mode, False)
    label = f"serve 4d {mode} {width}x{height}"
    r = api.InteractiveRenderer(settings, period_floor_ms=1e9)

    def at(t):
        return lambda: r.render_orbit(cloud, 0.0, SERVE_EL, SERVE_RADIUS, width=width, height=height, time=t)

    cap = rt.pairs_budget(len(cloud))
    log(f"[{label}] the JAX package's pair-order replay (not ported) would gather at the 6N cap {cap} rows of {cloud_row_bytes(cloud)} bytes, "
        f"{cap * cloud_row_bytes(cloud)} bytes (the 1M cloud: {len(cloud) * cloud_row_bytes(cloud)})")
    expand_pairs.launches = 0
    composite_tiles_raw.instances.clear()
    served(at(TIME_4D), instance, 1, f"{label} first frame")
    first = dict(r.stats)
    sweep = []
    for i in range(SERVE_FRAMES_4D):
        img, dt = served(at(TIME_4D + 0.01 * (i + 1)), instance, 1, f"{label} sweep frame {i}")
        sweep.append(dt)
    swept = dict(r.stats)
    t_last = TIME_4D + 0.01 * SERVE_FRAMES_4D
    binned, dt_bin = served(at(t_last), instance, 1, f"{label} settled bin")
    replay, dt_replay = served(at(t_last), instance, 0, f"{label} settled replay")
    bitwise = bool(torch.equal(binned, img)) and bool(torch.equal(replay, img))
    launches = {"expand_pairs": expand_pairs.launches, "composite_tiles_raw": composite_tiles_raw.instances[instance]}
    log(f"[{label}] first frame {first}, after a sweep of {SERVE_FRAMES_4D} times {swept}, settled "
        f"{dict(r.stats)}; one-pass frames median {statistics.median(sweep):.3f} ms (the JAX bench's "
        f"gs4d_rebin_ms), settled bin {dt_bin:.3f} ms, replay {dt_replay:.3f} ms; settled frames bitwise the "
        f"one-pass frame {bitwise}")
    if swept != {"bins": 1, "replays": 0, "oneshots": SERVE_FRAMES_4D}:
        raise AssertionError(f"{label}: the time sweep counted {swept}")
    if dict(r.stats) != {"bins": 2, "replays": 1, "oneshots": SERVE_FRAMES_4D} or not bitwise:
        raise AssertionError(f"{label}: settled time {r.stats}, bitwise {bitwise}")
    return launches


def phase_multi_camera(cloud) -> dict:
    """``render_multi_camera`` over the main phase's four orbit poses at
    512x512 (OBB): each view bitwise its own ``render_tiled`` -> launches."""
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.render.multi_camera import render_multi_camera

    width, height = SIZES[0]
    cams = [orbit_camera(az, width, height, cloud.device) for az in ORBIT_AZ]
    expand_pairs.launches = 0
    composite_tiles_raw.instances.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = render_multi_camera(cloud, cams)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    launches = {"expand_pairs": expand_pairs.launches,
                "composite_tiles_raw": composite_tiles_raw.instances.get(("obb", False), 0)}
    if launches != {"expand_pairs": len(cams), "composite_tiles_raw": len(cams)}:
        raise AssertionError(f"multi-camera launches {launches}")
    equal = [bool(torch.equal(batch[i], render_tiled(cloud, c, CloudSettings(), differentiable=False)))
             for i, c in enumerate(cams)]
    log(f"[multi-camera obb {width}x{height}] {len(cams)} views {tuple(batch.shape)} in {dt:.3f} ms; each view "
        f"bitwise its own render_tiled: {equal}")
    if not all(equal) or not bool(torch.isfinite(batch).all()):
        raise AssertionError("a multi-camera view differs from its own render")
    return launches


def background_image(width: int, height: int, device) -> torch.Tensor:
    """A smooth full-image RGBA background."""
    y = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    x = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    return torch.stack([0.2 + 0.6 * x.expand(height, width), 0.1 + 0.5 * y.expand(height, width),
                        0.3 + 0.4 * x * y, 0.5 + 0.5 * x.expand(height, width)], dim=-1)


def phase_background(cloud) -> None:
    """Full-image [H, W, 4] backgrounds (OBB): a frame of the 1M scene at each
    size against the frame without one blended under its transmittance (the
    1080p pad rows are cropped); a small scene at 128x120 card against CPU
    and against the oracle; the background's gradient card against CPU."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.render import api

    settings = CloudSettings()
    for width, height in SIZES:
        cam = orbit_camera(0.3, width, height, cloud.device)
        bg = background_image(width, height, cloud.device)
        img = api.render(cloud, cam, settings, background=bg)
        bare = api.render(cloud, cam, settings)
        want = bare + (1.0 - bare[..., 3:4]) * bg
        err = float((img - want).abs().max())
        log(f"[background obb {width}x{height}] full-image frame {tuple(img.shape)} vs the bare frame blended "
            f"under its transmittance {err:.3e} (bar {BG_BLEND_BAR})")
        if img.shape != (height, width, 4) or err > BG_BLEND_BAR:
            raise AssertionError(f"full-image background at {width}x{height}: {err:.3e}")
    a = bench_arrays(2000, seed=3)
    width, height = 128, 120
    cam = orbit_camera(0.0, width, height, "cpu")
    bg = background_image(width, height, "cpu")
    compare_small(f"obb bench2000 {width}x{height} full-image background", a, cam, settings, bg)
    grads = {}
    for dev in ("cpu", "cuda"):
        b = bg.to(dev).clone().requires_grad_(True)
        c = cloud_from_numpy(a, dev)
        torch.mean((render_tiled(c, cam.to(dev), settings, background=b) - 0.5) ** 2).backward()
        grads[dev] = b.grad.cpu()
    rel = float((grads["cuda"] - grads["cpu"]).abs().max() / grads["cpu"].abs().max())
    log(f"[background obb {width}x{height}] background gradient card vs cpu, max |diff| / max |cpu| {rel:.3e} "
        f"(bar {GRAD_BAR})")
    if rel > GRAD_BAR:
        raise AssertionError(f"background gradient card vs cpu {rel:.3e}")


def phase_examples() -> None:
    """The port's five examples, each on the card, writing its PNGs into the
    output directory with the port's PNG writer, read back by its reader
    (the streaming flyby's last frame)."""
    import os

    from bevy_gaussian_splatting_tpu_torch.examples import (
        minimal,
        multi_camera,
        streaming_lod,
        train_multiview,
        training,
    )
    from bevy_gaussian_splatting_tpu_torch.utils.image import load_png, non_black_pixel_count

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    for name, module in (("minimal", minimal), ("multi_camera", multi_camera), ("training", training),
                         ("train_multiview", train_multiview), ("streaming_lod", streaming_lod)):
        path = out / f"example_{name}.png"
        t0 = time.perf_counter()
        if name == "streaming_lod":  # its flyby frames, by its environment knobs
            os.environ["FLY_OUT"] = str(out)
            rc = module.main([])
            path = out / f"flyby_{int(os.environ.get('FLY_FRAMES', 5)) - 1:02d}.png"
        else:
            rc = module.main(["--out", str(path)])
        if rc != 0:
            raise AssertionError(f"example {name} failed")
        img = load_png(path)
        lit = non_black_pixel_count(img)
        log(f"[example {name}] {time.perf_counter() - t0:.2f} s, {path.name} {img.shape[1]}x{img.shape[0]}, "
            f"{lit} non-black pixels")
        if lit == 0 or not np.isfinite(img).all():
            raise AssertionError(f"example {name} wrote an unlit image")


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Norm of the difference over the norm of ``want``."""
    return float((got.double() - want.double()).norm() / want.double().norm())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def clouds_bitwise(a, b) -> bool:
    return type(a) is type(b) and all(
        same_bits(getattr(a, f.name).cpu(), getattr(b, f.name).cpu()) for f in dataclasses.fields(a))


def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, as its CSV line gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def decoder_paths() -> dict:
    """The decode counters of the port's IO: the PLY decoders, the .gcloud
    decoders and the FlexBuffers reader's two paths."""
    from bevy_gaussian_splatting_tpu_torch.io import flexbuffers, gcloud, ply

    return {**{f"ply {k}": v for k, v in ply.parse_ply_3d.paths.items()},
            **{f"gcloud {k}": v for k, v in gcloud.decode_paths.items()},
            **{f"flexbuffers {k}": v for k, v in flexbuffers.read_columns.paths.items()}}


def io_native_turns(tmp: Path, cloud, cloud4) -> None:
    """The native runtime against the decoders it replaced as the default, on
    the files phase 20 saved in ``tmp``: each file loaded by ``load_any``
    (native) and by the port's numpy decoder of the same bytes
    (``use_native=False``: the PLY decoder, the FlexBuffers reader), in
    turns; agreement; the encoders' bytes; the radix sort against a stable
    argsort.  Host times on the card's machine, each beside the card's name
    and power limit."""
    from bevy_gaussian_splatting_tpu_torch import native
    from bevy_gaussian_splatting_tpu_torch.io import flexbuffers
    from bevy_gaussian_splatting_tpu_torch.io import gcloud as gcloud_codec
    from bevy_gaussian_splatting_tpu_torch.io import ply as ply_codec
    from bevy_gaussian_splatting_tpu_torch.io.loader import load_any
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_to_numpy

    card = card_name_and_limit()
    numpy_decoders = {
        "bench.ply": (lambda data: ply_codec.parse_ply_3d(data, use_native=False), "ply"),
        "bench.gcloud": (lambda data: gcloud_codec.decode_gcloud_3d(data, use_native=False), "gcloud"),
        "bench4d.gc4d": (lambda data: gcloud_codec.decode_gcloud_4d(data, use_native=False), "gcloud"),
    }
    for name, (decode, counter) in numpy_decoders.items():
        path = str(tmp / name)

        def load_numpy():
            with open(path, "rb") as f:
                return decode(f.read())

        ways = {"native": lambda: load_any(path), "numpy": load_numpy}
        times, loaded = {"native": [], "numpy": []}, {}
        before = decoder_paths()
        for turn in range(NATIVE_TURNS):
            for way in ("native", "numpy") if turn % 2 == 0 else ("numpy", "native"):
                loaded.pop(way, None)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loaded[way] = ways[way]()
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
        paths = {k: v - before[k] for k, v in decoder_paths().items() if v != before[k]}
        slow = "numpy" if counter == "ply" else "flexbuffers"
        if paths.get(f"{counter} native") != NATIVE_TURNS or paths.get(f"{counter} {slow}") != NATIVE_TURNS:
            raise AssertionError(f"io native {name}: decoders taken {paths}")
        med = {way: statistics.median(t) for way, t in times.items()}
        for way in ("native", "numpy"):
            log(f"[io native {name}] {way}: median {med[way]:.1f} ms of {NATIVE_TURNS} turns "
                f"({', '.join(f'{t:.1f}' for t in times[way])}; read, decode, upload) | {card}")
        a, b = cloud_to_numpy(loaded["native"]), cloud_to_numpy(loaded["numpy"])
        if name == "bench.ply":
            errs = {k: float(np.abs(a[k] - b[k]).max()) for k in a}
            differ = {k: int((a[k] != b[k]).sum()) for k in a}
            agree = (f"within {NATIVE_PLY_BAR} ({max(errs.values()):.3e} at most); elements that differ "
                     + ", ".join(f"{k} {differ[k]} of {a[k].size}" for k in a))
            ok = max(errs.values()) <= NATIVE_PLY_BAR
        else:
            ok = clouds_bitwise(loaded["native"], loaded["numpy"])
            agree = "array-equal" if ok else "DIFFER"
        log(f"[io native {name}] {len(loaded['native'])} rows: speedup {med['numpy'] / med['native']:.2f}x "
            f"(numpy median over native median) | native against numpy {agree}")
        if not ok:
            raise AssertionError(f"io native {name}: the two decoders disagree ({agree})")
        loaded.clear()

    with open(tmp / "bench.gcloud", "rb") as f:
        native3 = f.read()
    t0 = time.perf_counter()
    again = gcloud_codec.encode_gcloud_3d(cloud)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    port3 = gcloud_codec.encode_gcloud_3d(cloud, use_native=False)
    port_ms = (time.perf_counter() - t0) * 1e3
    native4 = gcloud_codec.encode_gcloud_4d(cloud4)
    before = dict(flexbuffers.read_columns.paths)
    read4 = gcloud_codec.decode_gcloud_4d(native4, use_native=False)
    vectorised = flexbuffers.read_columns.paths["vectorised"] - before["vectorised"]
    same3, same4 = native3 == again == port3, clouds_bitwise(read4, cloud4)
    ok = same3 and same4 and vectorised == 1
    log(f"[io native encode] {len(cloud)}-row .gcloud: native {native_ms:.1f} ms, the port's FlexBuffers writer "
        f"{port_ms:.1f} ms (read-back included), bytes equal: {same3} ({len(native3)} B) | the native .gc4d "
        f"({len(native4)} B) read by the FlexBuffers reader's vectorised path array-equal: {same4} | {card}")
    if not ok:
        raise AssertionError("io native: the encoders' bytes or the 4D read-back differ")

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, SORT_PAIRS, dtype=np.uint64).astype(np.uint32)
    keys[::3] %= 4096  # duplicate keys: the sort must be stable
    values = np.arange(SORT_PAIRS, dtype=np.uint32)
    sort_times = {"radix": [], "argsort": []}
    for turn in range(NATIVE_TURNS):
        for way in ("radix", "argsort") if turn % 2 == 0 else ("argsort", "radix"):
            k, v = keys.copy(), values.copy()
            t0 = time.perf_counter()
            if way == "radix":
                got = native.radix_sort_pairs(k, v)
            else:
                order = np.argsort(k, kind="stable")
                want = (k[order], v[order])
            sort_times[way].append((time.perf_counter() - t0) * 1e3)
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    log(f"[io native radix_sort_pairs] {SORT_PAIRS} u32 pairs, a third of the keys below 4096: equal to a stable "
        f"np.argsort: {equal} | median of {NATIVE_TURNS} turns: radix {statistics.median(sort_times['radix']):.2f} ms, "
        f"argsort and gather {statistics.median(sort_times['argsort']):.2f} ms | {card}")
    if not equal:
        raise AssertionError("radix_sort_pairs differs from a stable argsort")


def phase_io(cloud, arrays: dict) -> dict:
    """Cloud and scene files, scene rendering, query, morph and noise on the 1M
    scene (OBB): save it with the port's encoders in every format, load each
    with ``load_any`` on the card (lossless formats bitwise the source and
    their frame bitwise the in-memory frame; PLY and GLB bitwise the CPU's
    decode of the same bytes), the native runtime against the decoders it
    replaced (``io_native_turns``), ``render_scene`` on the GLB's two clouds,
    then ``points_in_mesh``, ``interpolate_clouds``, ten particle steps,
    ``_hash4`` and ``apply_noise`` card against CPU, each result rendered
    once -> the forward kernels' launches."""
    import tempfile

    from bevy_gaussian_splatting_tpu_torch.device import resolve_device
    from bevy_gaussian_splatting_tpu_torch.io.loader import load_any, save_cloud
    from bevy_gaussian_splatting_tpu_torch.io.scene import GaussianScene, SceneCamera, SceneCloud
    from bevy_gaussian_splatting_tpu_torch.io.scene import write_khr_gaussian_scene_glb
    from bevy_gaussian_splatting_tpu_torch.models.cloud import (
        cloud_from_numpy,
        precompute_covariance_3d,
        random_arrays_4d_seeded,
    )
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.morph.interpolate import interpolate_clouds
    from bevy_gaussian_splatting_tpu_torch.morph.particle import ParticleBehaviors, apply_particle_behaviors
    from bevy_gaussian_splatting_tpu_torch.ops import noise
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.expand import expand_pairs
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import composite_tiles_raw
    from bevy_gaussian_splatting_tpu_torch.query.raycast import points_in_mesh
    from bevy_gaussian_splatting_tpu_torch.render import api
    from bevy_gaussian_splatting_tpu_torch.render.scene import camera_from_scene, render_scene

    settings = CloudSettings()
    dev = resolve_device(None)
    expand_pairs.launches = 0
    composite_tiles_raw.instances.clear()

    def frame(c, cam, **kw):
        img = api.render(c, cam, settings, **kw)
        lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
        if not bool(torch.isfinite(img).all()) or lit < LIT_FLOOR * cam.width * cam.height:
            raise AssertionError(f"io: a frame of {tuple(img.shape)} is not finite or has only {lit} lit pixels")
        return img

    small = {k: v[:IO_SMALL_ROWS] for k, v in arrays.items()}
    near = {k: v.copy() for k, v in bench_arrays(IO_SMALL_ROWS, seed=1).items()}
    arrays4 = random_arrays_4d_seeded(IO_SMALL_ROWS, seed=SEED_4D)
    cloud4 = cloud_from_numpy(arrays4, dev)
    cov = precompute_covariance_3d(cloud_from_numpy(small, dev), f16_quantize=True)  # the file's f16 pairs
    near_t = np.eye(4, dtype=np.float32)
    near_t[:3, 3] = SCENE_SHIFT
    cam_t = np.eye(4, dtype=np.float32)
    cam_t[:3, 3] = (0.0, 0.0, 60.0)  # the bench camera: (0, 0, 60) looking down -z
    scene_clouds = [SceneCloud("bench", cloud, np.eye(4, dtype=np.float32), settings, {}),
                    SceneCloud("near", cloud_from_numpy(near, dev), near_t, settings, {})]
    scene_cam = SceneCamera("bench_camera", cam_t, yfov_radians=float(np.pi / 4), znear=0.1)
    cam512 = orbit_camera(0.0, *SIZES[0], dev)
    ref = frame(cloud, cam512)

    with tempfile.TemporaryDirectory() as tmp:
        # (file, cloud, codec, lossless); 4D and cov3d at IO_SMALL_ROWS
        files = [("bench.gcloud", cloud, "flexbuffers", True), ("bench.bincode.gcloud", cloud, "bincode2", True),
                 ("bench.npz", cloud, "flexbuffers", True), ("bench.ply", cloud, "flexbuffers", False),
                 ("bench.glb", None, "flexbuffers", False),
                 ("bench4d.gc4d", cloud4, "flexbuffers", True), ("bench4d.bincode.gc4d", cloud4, "bincode2", True),
                 ("bench4d.ply4d", cloud4, "flexbuffers", False), ("bench_cov3d.gcloud", cov, "flexbuffers", True)]
        scene = None
        for name, src, codec, lossless in files:
            path = str(Path(tmp) / name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if src is None:
                nbytes = write_khr_gaussian_scene_glb(scene_clouds, path, camera=scene_cam)
            else:
                nbytes = save_cloud(src, path, codec=codec)
            enc_ms = (time.perf_counter() - t0) * 1e3
            paths_before = decoder_paths()
            t0 = time.perf_counter()
            loaded = load_any(path)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3
            paths = {k: v - paths_before[k] for k, v in decoder_paths().items() if v != paths_before[k]}
            got = loaded.clouds if src is None else [loaded]
            if any(c.device != dev for c in (g.cloud if src is None else g for g in got)):
                raise AssertionError(f"io {name}: loaded off the card")
            if lossless:
                check = "bitwise the source" if clouds_bitwise(loaded, src) else None
            else:  # the same bytes decoded on the CPU
                cpu = load_any(path, device="cpu")
                pairs = zip(loaded.clouds, cpu.clouds) if src is None else [(loaded, cpu)]
                check = "bitwise the CPU's decode" if all(
                    clouds_bitwise(a.cloud if src is None else a, b.cloud if src is None else b)
                    for a, b in pairs) else None
            if check is None:
                raise AssertionError(f"io {name}: the loaded cloud differs")
            note = ""
            want = {"bench.gcloud": {"gcloud native": 1}, "bench.ply": {"ply native": 1}}.get(name)
            if want is not None:
                if paths != want:
                    raise AssertionError(f"io {name}: decoded by the paths {paths}, not {want}")
                note = "; decoded by the native runtime"
            if lossless and src is cloud:
                if not same_bits(frame(loaded, cam512), ref):
                    raise AssertionError(f"io {name}: its frame differs from the in-memory cloud's")
                note += "; its 512x512 frame bitwise the in-memory frame"
            if src is None:
                scene = loaded
            rows = sum(len(c.cloud) for c in loaded.clouds) if src is None else len(loaded)
            log(f"[io {name}] {rows} rows, {nbytes} bytes | save {enc_ms:.1f} ms, load_any {dec_ms:.1f} ms "
                f"(decode and upload) | {check}{note}")
        io_native_turns(Path(tmp), cloud, cloud4)

    # render_scene on the GLB: far to near, each image the next cloud's background
    for width, height in SIZES:
        cam = camera_from_scene(scene, width, height)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_scene(scene, cam)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        far, nearc = scene.clouds  # the bench cloud at distance 60 renders first
        by_hand = frame(nearc.cloud, cam, model_transform=torch.as_tensor(nearc.transform, device=dev),
                        background=frame(far.cloud, cam, model_transform=torch.as_tensor(far.transform, device=dev)))
        lit = int((img[..., :3].abs().amax(dim=-1) > 1.0 / 255.0).sum())
        ok = same_bits(img, by_hand) and bool(torch.isfinite(img).all()) and lit >= LIT_FLOOR * width * height
        log(f"[io render_scene {width}x{height}] 2 clouds ({len(far.cloud)} + {len(nearc.cloud)}), {ms:.1f} ms, lit "
            f"{lit}, bitwise the two render() calls chained by hand: {same_bits(img, by_hand)}")
        if not ok:
            raise AssertionError(f"render_scene {width}x{height}")
    cut = GaussianScene([dataclasses.replace(sc, cloud=type(sc.cloud)(**{
        f.name: getattr(sc.cloud, f.name)[:IO_SMALL_ROWS] for f in dataclasses.fields(sc.cloud)}))
        for sc in scene.clouds], scene.cameras)
    cut_cpu = GaussianScene([dataclasses.replace(sc, cloud=sc.cloud.to("cpu")) for sc in cut.clouds], cut.cameras)
    width, height = SCENE_CPU_SIZE
    card = render_scene(cut, camera_from_scene(cut, width, height)).cpu()
    t0 = time.perf_counter()
    cpu = render_scene(cut_cpu, camera_from_scene(cut_cpu, width, height, device="cpu"), device="cpu")
    err = float((card - cpu).abs().max())
    log(f"[io render_scene {width}x{height}] the GLB's clouds cut to {IO_SMALL_ROWS} rows each, card vs CPU {err:.3e} "
        f"(bar {SCENE_CPU_BAR}; CPU {time.perf_counter() - t0:.1f} s)")
    if not err <= SCENE_CPU_BAR:
        raise AssertionError(f"render_scene card vs CPU {err:.3e}")

    # query, morph and noise at 1M, card against CPU, each result rendered once
    cpu_cloud = cloud.to("cpu")
    unit = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                    np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                      [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]], np.int32)
    lo, hi = np.array([-10.0, -8.0, -2.0], np.float32), np.array([12.0, 9.0, 3.0], np.float32)
    box = np.diag([*(hi - lo), 1.0]).astype(np.float32)
    box[:3, 3] = lo
    inside = points_in_mesh(cloud.position, unit, faces, torch.from_numpy(box)).cpu()
    inside_cpu = points_in_mesh(cpu_cloud.position, unit, faces, torch.from_numpy(box))
    flips = (inside != inside_cpu).nonzero()[:, 0]
    q = (cpu_cloud.position[flips].numpy() - lo) / (hi - lo)  # the flips in the unit box's frame
    edge = np.minimum(np.minimum(np.abs(q), np.abs(q - 1.0)).min(axis=1), np.abs(q[:, 1] - q[:, 2]) / np.sqrt(2.0))
    boundary = int((edge <= MESH_BOUNDARY).sum())
    log(f"[io points_in_mesh] 12-triangle box, {int(inside.sum())} of {len(inside)} inside; card vs CPU flips "
        f"{len(flips)} ({boundary} within {MESH_BOUNDARY} of a face or a face diagonal)")
    if boundary != len(flips):
        raise AssertionError(f"points_in_mesh: {len(flips) - boundary} flips away from the mesh's boundary")
    selected = cloud.with_visibility(inside.to(dev, torch.float32))

    rhs = cloud_from_numpy({k: np.ascontiguousarray(v[::-1]) for k, v in arrays.items()}, dev)
    mixed = interpolate_clouds(cloud, rhs, 0.37)
    mixed_cpu = interpolate_clouds(cpu_cloud, rhs.to("cpu"), 0.37)
    err_mix = max(float((getattr(mixed, f.name).cpu() - getattr(mixed_cpu, f.name)).abs().max())
                  for f in dataclasses.fields(mixed))
    log(f"[io interpolate_clouds] t 0.37, card vs CPU {err_mix:.3e} (bar {INTERP_BAR})")
    if not err_mix <= INTERP_BAR:
        raise AssertionError(f"interpolate_clouds card vs CPU {err_mix:.3e}")

    n = len(cloud)
    idx = (np.arange(n + n // 64) % n).astype(np.int32)  # rows 0 .. n/64 driven twice
    idx[::97] = -1  # inert
    beh_cpu = dataclasses.replace(ParticleBehaviors.random(len(idx), seed=7, device="cpu"),
                                  indices=torch.from_numpy(idx))
    beh = ParticleBehaviors(**{f.name: getattr(beh_cpu, f.name).to(dev) for f in dataclasses.fields(beh_cpu)})
    moved, moved_cpu = cloud, cpu_cloud
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PARTICLE_STEPS):
        moved, beh = apply_particle_behaviors(moved, beh, 1.0 / 30.0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PARTICLE_STEPS
    for _ in range(PARTICLE_STEPS):
        moved_cpu, beh_cpu = apply_particle_behaviors(moved_cpu, beh_cpu, 1.0 / 30.0)
    diff = (moved.position_visibility.cpu() - moved_cpu.position_visibility).abs().amax(dim=1)
    twice = torch.zeros(n, dtype=torch.bool)
    twice[: n // 64] = True
    err_p = float(diff.max())
    log(f"[io particles] {PARTICLE_STEPS} steps of {len(idx)} behaviours ({n // 64} rows driven twice, every 97th "
        f"inert), {step_ms:.3f} ms/step; card vs CPU {err_p:.3e} (bar {PARTICLE_BAR}): rows driven once "
        f"{float(diff[~twice].max()):.3e}, twice {float(diff[twice].max()):.3e}, rows differing {int((diff > 0).sum())}")
    if not err_p <= PARTICLE_BAR:
        raise AssertionError(f"particle steps card vs CPU {err_p:.3e}")

    pos = cloud.position * 2.0
    lattice = [torch.floor(pos[:, k]).to(torch.int32) for k in range(3)]
    lattice.append(torch.arange(n, device=dev, dtype=torch.int32) % 48 - 24)  # negative w cells too
    h = noise._hash4(*lattice, 3).cpu()
    h_cpu = noise._hash4(*(c.cpu() for c in lattice), 3)
    hash_flips = int((h != h_cpu).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noised = noise.apply_noise(cloud, scale=0.5, seed=1)
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3
    rows = torch.arange(0, n, NOISE_CPU_STRIDE)
    sub = type(cpu_cloud)(**{f.name: getattr(cpu_cloud, f.name)[rows] for f in dataclasses.fields(cpu_cloud)})
    sh_cpu = noise.apply_noise(sub, scale=0.5, seed=1).spherical_harmonic
    sh_card = noised.spherical_harmonic[rows.to(dev)].cpu()
    err_n = float((sh_card - sh_cpu).abs().max())
    p_card = (cloud.position[rows.to(dev)] * 0.5).cpu()
    p_cpu = sub.position * 0.5
    cell_flips = int((torch.floor(p_card) != torch.floor(p_cpu)).any(dim=1).sum())
    log(f"[io noise] _hash4 at {n} lattice points (negative cells included) card vs CPU: {hash_flips} differ; "
        f"apply_noise {n} x {noised.spherical_harmonic.shape[1]} in {noise_ms:.1f} ms, card vs CPU on every "
        f"{NOISE_CPU_STRIDE}th row {err_n:.3e} (bar {NOISE_SH_BAR}), lattice-cell flips {cell_flips}")
    if hash_flips or not err_n <= NOISE_SH_BAR:
        raise AssertionError(f"noise: {hash_flips} hashes differ, SH card vs CPU {err_n:.3e}")

    for c in (selected, mixed, moved, noised):
        frame(c, cam512)
    launches = {"expand_pairs": expand_pairs.launches,
                "composite_tiles_raw": composite_tiles_raw.instances.get(("obb", False), 0)}
    if set(composite_tiles_raw.instances) != {("obb", False)} or min(launches.values()) <= 0:
        raise AssertionError(f"io: forward launches {launches}, instantiations {composite_tiles_raw.instances}")
    log(f"[io] launches expand_pairs {launches['expand_pairs']}, composite_tiles_raw[obb] "
        f"{launches['composite_tiles_raw']}")
    return launches


def obb_counts() -> tuple:
    """The four kernels' launch counters, the forward compositor's for its
    3D OBB instantiation only."""
    expand, fwd, bwd, red = train_counters()
    return (expand.launches, fwd.instances.get(("obb", False), 0), bwd.launches, red.launches)


OBB_NAMES = ("expand_pairs", "composite_tiles_raw", "composite_backward", "segment_reduce")


@contextlib.contextmanager
def obb_launches(totals: dict):
    """Adds the block's OBB launches to ``totals``; the phase's frames of
    other modes (the gallery's AABB, 2DGS and 4DGS examples) run outside
    such blocks."""
    before = obb_counts()
    yield
    for name, b, a in zip(OBB_NAMES, before, obb_counts()):
        totals[name] += a - b


def quiet_main(main_fn, argv) -> str:
    """``main_fn(argv)`` with its standard output captured -> that output;
    raises unless it returned 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__}.main({argv}) returned {rc}: {buf.getvalue()}")
    return buf.getvalue()


def png_u8(path) -> np.ndarray:
    from bevy_gaussian_splatting_tpu_torch.utils.image import decode_png

    return decode_png(Path(path).read_bytes())


def within_u8(card_png, cpu_png, label: str) -> int:
    """The two PNGs' largest difference, which must be at most one u8 level
    with some pixel lit -> the count of lit pixels."""
    a, b = png_u8(card_png).astype(np.int32), png_u8(cpu_png).astype(np.int32)
    diff = int(np.abs(a - b).max()) if a.shape == b.shape else None
    lit = int((a[..., :3].max(axis=-1) > 0).sum())
    if diff is None or diff > PNG_BAR or lit == 0:
        raise AssertionError(f"{label}: card vs CPU PNG {a.shape} {b.shape} differ by {diff} levels, {lit} lit")
    return lit


def gif_frame_count(blob: bytes) -> tuple:
    """(frames, width, height) of a GIF89a, from its block structure."""
    if blob[:6] != b"GIF89a":
        raise AssertionError("not a GIF89a file")
    width, height, flags = int.from_bytes(blob[6:8], "little"), int.from_bytes(blob[8:10], "little"), blob[10]
    pos, frames = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0), 0
    while blob[pos] != 0x3B:
        if blob[pos] == 0x21:  # extension: label, then data sub-blocks
            pos += 2
        else:  # image descriptor, optional local table, LZW minimum code size
            frames += 1
            local = blob[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0) + 1
        while blob[pos]:
            pos += blob[pos] + 1
        pos += 1
    return frames, width, height


def phase_front_ends(cloud, arrays: dict) -> dict:
    """Streaming and LOD, checkpoints, the trace, the headless CLI, the
    browser viewer and the tool CLIs on the 1M scene (OBB), in a temporary
    working directory -> the OBB launches of its frames and steps."""
    import os
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud, save_cloud
    from bevy_gaussian_splatting_tpu_torch.models.camera import Camera
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, pad_cloud
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings
    from bevy_gaussian_splatting_tpu_torch.render import api
    from bevy_gaussian_splatting_tpu_torch.stream import build_lod_chain, concat_clouds, slice_cloud
    from bevy_gaussian_splatting_tpu_torch.stream.scene import StreamingCloudScene, save_streaming_scene
    from bevy_gaussian_splatting_tpu_torch.stream.slice import aabb_distance
    from bevy_gaussian_splatting_tpu_torch.tools import (
        compare_aabb_obb,
        orbit_turntable,
        ply_to_gcloud,
        surfel_plane,
    )
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud, adam, shifted_arrays
    from bevy_gaussian_splatting_tpu_torch.train.losses import mse
    from bevy_gaussian_splatting_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from bevy_gaussian_splatting_tpu_torch.utils.image import encode_png, to_srgb_u8
    from bevy_gaussian_splatting_tpu_torch.utils.trace import StageTimer, trace
    from bevy_gaussian_splatting_tpu_torch.viewer import headless, serve

    settings = CloudSettings()
    launches = dict.fromkeys(OBB_NAMES, 0)
    timer = StageTimer()
    cpu_cloud = cloud.to("cpu")
    n = len(cloud)
    old_cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="front_ends_")
    os.chdir(tmp)
    try:
        # -- stream: slice, save, fly a camera across the grid, LOD ------------------------------------
        chunks = slice_cloud(cloud, grid=STREAM_GRID)
        chunks_cpu = slice_cloud(cpu_cloud, grid=STREAM_GRID)
        if sum(len(c) for c in chunks) != n or [c.cell for c in chunks] != [c.cell for c in chunks_cpu] or not all(
                clouds_bitwise(a.cloud, b.cloud) and np.array_equal(a.aabb_min, b.aabb_min)
                and np.array_equal(a.aabb_max, b.aabb_max) for a, b in zip(chunks, chunks_cpu)):
            raise AssertionError("stream: the card's slice differs from the CPU's")
        t0 = time.perf_counter()
        save_streaming_scene(chunks, "scene")
        save_ms = (time.perf_counter() - t0) * 1e3
        files = sorted(os.listdir("scene"))
        nbytes = sum(os.path.getsize(os.path.join("scene", f)) for f in files if f.endswith(".gcloud"))
        log(f"[front stream] slice_cloud grid {STREAM_GRID} on the card: {len(chunks)} chunks of "
            f"{min(map(len, chunks))}-{max(map(len, chunks))} rows, {n} rows in all, rows and AABBs bitwise the "
            f"CPU's; save_streaming_scene {len(files) - 1} files, {nbytes} bytes ({nbytes / n:.1f} B a row), "
            f"{save_ms:.1f} ms")
        del chunks, chunks_cpu
        stream = StreamingCloudScene("scene", radius=STREAM_RADIUS, background=True)
        entries, resident, cpu_chunks, load_ms, frame_ms = stream.entries, set(), {}, [], []
        try:
            for k, (x, y) in enumerate(STREAM_PATH):
                eye = (x, y, STREAM_HEIGHT)
                dist = [aabb_distance(e["aabb_min"], e["aabb_max"], eye) for e in entries]
                resident = {i for i, d in enumerate(dist) if d <= STREAM_RADIUS} | {
                    i for i in resident if dist[i] <= STREAM_RADIUS * stream.evict_factor}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stream.update(eye)
                stream.wait_idle()
                load_ms.append((time.perf_counter() - t0) * 1e3)
                if stream.resident_ids() != sorted(resident):
                    raise AssertionError(f"stream at {eye}: resident {stream.resident_ids()}, the manifest's AABBs "
                                         f"give {sorted(resident)}")
                got = stream.resident_cloud()
                for i in resident - cpu_chunks.keys():
                    cpu_chunks[i] = load_cloud(os.path.join("scene", entries[i]["file"]), device="cpu")
                parts = [cpu_chunks[i] for i in sorted(resident)]
                want = concat_clouds(parts) if len(parts) > 1 else parts[0]
                size = 1 << max(8, int(np.ceil(np.log2(len(want)))))
                if not clouds_bitwise(got, pad_cloud(want, size)):
                    raise AssertionError(f"stream at {eye}: the resident cloud is not the CPU's concatenation")
                cam = Camera.create(eye=eye, target=(x, y, 0.0), width=SIZES[0][0], height=SIZES[0][1], device="cuda")
                with obb_launches(launches):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    img = api.render(got, cam, settings)
                    torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                lit = int((img[..., :3].amax(dim=-1) > 1.0 / 255.0).sum())
                if not bool(torch.isfinite(img).all()) or lit == 0:
                    raise AssertionError(f"stream at {eye}: frame not finite or unlit ({lit} lit)")
                log(f"[front stream] update {k} eye {eye}: {len(resident)} chunks resident "
                    f"{sorted(resident)} ({len(got)} rows padded), load {load_ms[-1]:.1f} ms, frame "
                    f"{frame_ms[-1]:.1f} ms, {lit} lit; resident ids as the manifest's AABBs give, the cloud "
                    "bitwise the CPU's concatenation of the chunk files")
        finally:
            stream.close()
        log(f"[front stream] {len(STREAM_PATH)} updates, radius {STREAM_RADIUS}: load ms per update median "
            f"{statistics.median(load_ms):.1f} (max {max(load_ms):.1f}), frame ms median "
            f"{statistics.median(frame_ms):.1f}")
        del cpu_chunks, got, want, parts
        t0 = time.perf_counter()
        chain = build_lod_chain(cloud, levels=3, ratio=0.25)
        torch.cuda.synchronize()
        lod_ms = (time.perf_counter() - t0) * 1e3
        chain_cpu = build_lod_chain(cpu_cloud, levels=3, ratio=0.25)
        if not all(clouds_bitwise(a, b) for a, b in zip(chain, chain_cpu)):
            raise AssertionError("build_lod_chain: the card's levels differ from the CPU's")
        log(f"[front lod] build_lod_chain(levels=3, ratio=0.25) on the card in {lod_ms:.1f} ms: levels of "
            f"{[len(c) for c in chain]} rows, kept rows and compensated opacity bitwise the CPU's")
        del chain, chain_cpu

        # -- checkpoint: 2 Adam steps, save, load into a fresh model and Adam, one more step each ---------
        model = TrainableCloud(cloud)
        optimizer = adam(model, TRAIN_LR)
        target_cloud = cloud_from_numpy(shifted_arrays(arrays), "cuda")
        camera, p_max, _, target = train_target(model, target_cloud, settings, *SIZES[0])
        del target_cloud
        with obb_launches(launches):
            for k in range(2):
                with timer.span("train_step"):
                    checked_step(model, optimizer, camera, target, settings, mse, p_max, f"checkpoint step {k}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.span("save_checkpoint"):
            save_checkpoint("ckpt.npz", model, optimizer, step=2, extra={"p_max": p_max})
        ckpt_save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_bytes = os.path.getsize("ckpt.npz")
        fresh = TrainableCloud(cloud)
        fresh_opt = adam(fresh, TRAIN_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.span("load_checkpoint"):
            _, _, step, extra = load_checkpoint("ckpt.npz", fresh, fresh_opt)
            torch.cuda.synchronize()
        ckpt_load_ms = (time.perf_counter() - t0) * 1e3
        if step != 2 or int(extra["p_max"]) != p_max:
            raise AssertionError(f"checkpoint: step {step}, extra {extra}")
        with obb_launches(launches):
            with timer.span("train_step"):
                checked_step(model, optimizer, camera, target, settings, mse, p_max, "checkpoint live step")
            with timer.span("train_step"):
                checked_step(fresh, fresh_opt, camera, target, settings, mse, p_max, "checkpoint resumed step")
        same = [same_bits(getattr(model, f).detach(), getattr(fresh, f).detach()) for f in model.fields]
        log(f"[front checkpoint] {n} rows: {ckpt_bytes} bytes ({ckpt_bytes / n:.1f} B a row: fields and Adam's two "
            f"moments), save {ckpt_save_ms:.1f} ms, load into a fresh model and Adam {ckpt_load_ms:.1f} ms; the step "
            f"after it from the live and the loaded state bitwise equal: {all(same)} ({dict(zip(model.fields, same))})")
        if not all(same):
            raise AssertionError("checkpoint: the resumed step differs from the live one")
        del model, optimizer, fresh, fresh_opt, target

        # -- trace ------------------------------------------------------------------------------------
        cam512 = orbit_camera(0.0, *SIZES[0], "cuda")
        with obb_launches(launches):
            with timer.span("traced render"):
                with trace("trace") as prof:
                    api.render(cloud, cam512, settings)
        events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        named = {k: [name for name in kernels if k in name] for k in TRACE_KERNELS}
        log(f"[front trace] {os.path.basename(prof.trace_path)}: {len(events)} events, {len(kernels)} kernel names; "
            + ", ".join(f"{k}: {len(v)}" for k, v in named.items()))
        if not all(named.values()):
            raise AssertionError(f"trace: the Chrome trace names no {[k for k, v in named.items() if not v]}")
        log(f"[front trace] StageTimer.report(): {timer.report()}")

        # -- headless CLI -----------------------------------------------------------------------------
        out = quiet_main(headless.main, ["--test-model", "--width", "512", "--height", "512", "-o", "tm.png"])
        quiet_main(headless.main, ["--test-model", "--width", "512", "--height", "512", "-o", "tm_cpu.png",
                                   "--device", "cpu"])
        within_u8("tm.png", "tm_cpu.png", "headless --test-model")
        count = int(out.rsplit("(", 1)[1].split()[1])
        log(f"[front headless] --test-model 512x512: {count} non-black pixels (the JAX CLI: "
            f"{TEST_MODEL_NON_BLACK}, VERDICT.md:5); PNG within {PNG_BAR} u8 level of the CPU's")
        if count != TEST_MODEL_NON_BLACK:
            raise AssertionError(f"headless --test-model: {count} non-black pixels")
        with obb_launches(launches):
            out = quiet_main(headless.main, ["--gaussian-count", str(n), "--eye", "0", "0", "60", "--benchmark",
                                             str(HEADLESS_FRAMES), "-o", "bench.png"])
        first = float(out.split("first frame (incl. kernel build): ")[1].split("s")[0])
        steady = float(out.split("steady state: ")[1].split(" ms/frame")[0])
        log(f"[front headless] --gaussian-count {n} --eye 0 0 60 --benchmark {HEADLESS_FRAMES} at 512x512: first "
            f"frame {first:.3f} s, steady state {steady:.3f} ms/frame")
        # a user's time to the first frame: a fresh process (the kernels' libraries already built on disk)
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        cold = subprocess.run([sys.executable, "-m", "bevy_gaussian_splatting_tpu_torch.viewer.headless",
                               "--gaussian-count", str(n), "--eye", "0", "0", "60", "-o", "cold.png"],
                              capture_output=True, text=True, env=env, timeout=300)
        cold_s = time.perf_counter() - t0
        if cold.returncode != 0:
            raise AssertionError(f"headless in a fresh process: {cold.stderr[-2000:]}")
        cold_first = float(cold.stdout.split("first frame (incl. kernel build): ")[1].split("s")[0])
        log(f"[front headless] a fresh process, --gaussian-count {n} at 512x512: {cold_s:.2f} s from start to the "
            f"PNG written, its first frame {cold_first:.3f} s")
        manifest = json.loads((ROOT / "examples" / "examples.json").read_text())
        for ex in manifest["examples"]:
            argv = ["--width", str(GALLERY_SIZE), "--height", str(GALLERY_SIZE), *ex["args"]]
            args = headless.build_parser().parse_args(argv)
            obb_3d = not args.aabb and args.gaussian_mode == "gaussian_3d"
            t0 = time.perf_counter()
            if obb_3d:
                with obb_launches(launches):
                    quiet_main(headless.main, [*argv, "-o", f"{ex['id']}.png"])
            else:
                quiet_main(headless.main, [*argv, "-o", f"{ex['id']}.png"])
            card_ms = (time.perf_counter() - t0) * 1e3
            quiet_main(headless.main, [*argv, "-o", f"{ex['id']}_cpu.png", "--device", "cpu"])
            lit = within_u8(f"{ex['id']}.png", f"{ex['id']}_cpu.png", f"gallery {ex['id']}")
            log(f"[front gallery {ex['id']}] {GALLERY_SIZE}x{GALLERY_SIZE}: {lit} lit pixels, within {PNG_BAR} u8 "
                f"level of the CPU's; {card_ms:.1f} ms for the CLI on the card")

        # -- the viewer over HTTP ---------------------------------------------------------------------
        save_cloud(cloud, "bench.npz")
        args = headless.build_parser().parse_args(["--input-cloud", "bench.npz", "--eye", "0", "0", "60",
                                                   "--width", str(SIZES[0][0]), "--height", str(SIZES[0][1])])
        state = serve.build_state_from_args(args)
        state.interactive = api.InteractiveRenderer(state.settings, period_floor_ms=1e9)
        second = api.InteractiveRenderer(state.settings, period_floor_ms=1e9)
        server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(state, base_args=args))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def get(path: str) -> bytes:
            with urllib.request.urlopen(base + path, timeout=120) as r:
                return r.read()

        try:
            poses = [(VIEWER_AZ_STEP * i, VIEWER_EL, VIEWER_RADIUS) for i in range(VIEWER_FRAMES)]
            api._BUDGET_STATE.clear()  # both renderers see one budget schedule
            pngs, request_ms = [], []
            with obb_launches(launches):
                for az, el, r in poses:
                    t0 = time.perf_counter()
                    pngs.append(get(f"/frame?az={az!r}&el={el!r}&r={r!r}"))
                    request_ms.append((time.perf_counter() - t0) * 1e3)
            api._BUDGET_STATE.clear()
            render_ms, encode_ms, equal = [], [], 0
            with obb_launches(launches):
                for (az, el, r), png in zip(poses, pngs):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    img = second.render_orbit(state.cloud, az, el, r, target=tuple(state.target), width=state.width,
                                              height=state.height, background=state.background)
                    u8 = to_srgb_u8(img)
                    t1 = time.perf_counter()
                    want = encode_png(u8)
                    t2 = time.perf_counter()
                    render_ms.append((t1 - t0) * 1e3)
                    encode_ms.append((t2 - t1) * 1e3)
                    equal += png == want
            stats = dict(state.interactive.stats)
            log(f"[front viewer] {len(state.cloud)} gaussians at {state.width}x{state.height}, {VIEWER_FRAMES} /frame "
                f"requests along an orbit: median request {statistics.median(request_ms):.2f} ms, render only "
                f"(render_orbit and the read-back) {statistics.median(render_ms):.2f} ms, PNG encode only "
                f"{statistics.median(encode_ms):.2f} ms; first request {request_ms[0]:.1f} ms; renderer stats {stats}, "
                f"second renderer {second.stats}; {equal} of {VIEWER_FRAMES} PNGs bitwise the second renderer's")
            want_stats = {"bins": 1, "replays": VIEWER_FRAMES - 1, "oneshots": 0}
            if equal != VIEWER_FRAMES or stats != want_stats or second.stats != want_stats:
                raise AssertionError(f"viewer: {equal} PNGs equal, stats {stats} / {second.stats}")
            az, el, r = poses[0]
            rect = VIEWER_RECT
            host = Camera.create(eye=api.orbit_eye(az, el, r), width=state.width, height=state.height, device="cpu")
            clip = host.clip_from_view.numpy() @ host.view_from_world.numpy()
            h = np.concatenate([cpu_cloud.position.numpy(), np.ones((n, 1), np.float32)], 1) @ clip.T
            ndc = h[:, :2] / np.maximum(h[:, 3:4], 1e-8)
            px, py = (ndc[:, 0] + 1.0) * 0.5 * state.width, (1.0 - ndc[:, 1]) * 0.5 * state.height
            expect = int(((h[:, 3] > 1e-8) & (px >= rect[0]) & (px <= rect[2]) & (py >= rect[1])
                          & (py <= rect[3])).sum())
            body = get(f"/select?x0={rect[0]}&y0={rect[1]}&x1={rect[2]}&y1={rect[3]}&az={az}&el={el}&r={r}").decode()
            saved = get("/select/save").decode()
            kept = len(load_cloud("live_output.gcloud", device="cpu"))
            inverted = get("/select/invert").decode()
            cleared = get("/select/clear").decode()
            t0 = time.perf_counter()
            exported = get("/export").decode()
            export_ms = (time.perf_counter() - t0) * 1e3
            info = json.loads(get("/info"))
            log(f"[front viewer] /select: {body!r} (host numpy count {expect}); /select/save: {saved!r}, the file "
                f"loads to {kept} rows; /select/invert: {inverted!r}; /select/clear: {cleared!r}; /export: "
                f"{exported!r} in {export_ms:.1f} ms; /info {info}")
            if (body != f"selected {expect} gaussians" or kept != expect or expect == 0
                    or inverted != f"selected {len(state.cloud) - expect} gaussians"
                    or info["selected"] != len(state.cloud) or info["frames"] != VIEWER_FRAMES
                    or os.path.getsize("viewer_export.glb") <= n * 4):
                raise AssertionError("viewer: a selection, export or info route disagrees")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        del state, second

        # -- tools ------------------------------------------------------------------------------------
        small = cloud_from_numpy({k: v[:IO_SMALL_ROWS] for k, v in arrays.items()}, "cpu")
        save_cloud(small, "small.ply")
        sparse = ["--filter-sparse", "--radius", str(SPARSE_RADIUS)]
        out = quiet_main(ply_to_gcloud.main, ["small.ply", "sparse.gcloud", *sparse])
        quiet_main(ply_to_gcloud.main, ["small.ply", "sparse_cpu.gcloud", *sparse, "--device", "cpu"])
        a, b = load_cloud("sparse.gcloud", device="cpu"), load_cloud("sparse_cpu.gcloud", device="cpu")
        log(f"[front tools] ply_to_gcloud --filter-sparse --radius {SPARSE_RADIUS} on {IO_SMALL_ROWS} rows: "
            f"{out.splitlines()[1]}; {len(a)} rows, bitwise the CPU run's: {clouds_bitwise(a, b)}")
        if not clouds_bitwise(a, b) or not 0 < len(a) < IO_SMALL_ROWS:
            raise AssertionError("ply_to_gcloud: the card's rows differ from the CPU run's")
        for name, tool, argv in (("compare_aabb_obb", compare_aabb_obb, []), ("surfel_plane", surfel_plane, []),
                                 ("orbit_turntable", orbit_turntable, ["--test-model", "--gif"])):
            quiet_main(tool.main, [*argv, "-o", f"{name}.png"])
            quiet_main(tool.main, [*argv, "-o", f"{name}_cpu.png", "--device", "cpu"])
            lit = within_u8(f"{name}.png", f"{name}_cpu.png", name)
            note = ""
            if name == "orbit_turntable":
                frames, w, h = gif_frame_count(Path("orbit_turntable.gif").read_bytes())
                if frames != 8 or (w, h) != (128, 128):
                    raise AssertionError(f"orbit_turntable --gif: {frames} frames of {w}x{h}")
                note = f"; its GIF {frames} frames of {w}x{h}"
            log(f"[front tools] {name}: {lit} lit pixels, within {PNG_BAR} u8 level of the CPU's{note}")
    finally:
        os.chdir(old_cwd)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log("[front] OBB launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    if min(launches.values()) <= 0:
        raise AssertionError(f"front ends: OBB launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 22: multi-rank band rendering and training (parallel/)
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 4  # a gloo world on the one card
PARALLEL_SIZE = SIZES[0]  # 512 rows: 4 bands of 8 tile rows
# every sharded frame must be bitwise the one-device frame (same chunk grid
# and k_max per band); the JAX tests' bars are printed beside it as a
# secondary reading (tests/test_parallel.py:48-69, test_4dgs_temporal: the
# share of pixels past 3e-5 under 0.01, the max under 0.1)
PARALLEL_BAR = {"obb": 3e-5, "aabb": 3e-5, "2d": 3e-4}
PARALLEL_4D_BARS = (3e-5, 0.01, 0.1)
# sharded vs one-device gradients, of each field's largest magnitude: only the
# order of the sums over bands differs (5.6e-8 at most on the H100, PERF.md)
PARALLEL_GRAD_REL = 1e-6
PARALLEL_REPS = 5  # timed frames and steps per rank
PARALLEL_AZ = (0.0, 0.3)  # the multi-camera batch's orbit poses
_RANK_SCENES: dict = {}  # a phase-22 rank's scenes, built once in its own process


def _p22_settings(mode: str):
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode

    return {
        "obb": CloudSettings(), "aabb": CloudSettings(aabb=True),
        "2d": CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D),
        "4d-obb": CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, time=TIME_4D),
    }[mode]


def _p22_scene(kind: str):
    """(cloud, target cloud) of the 1M bench scene ("3d") or the 4D bench
    scene ("4d", no target) on the card, made from the seed in this rank."""
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, random_arrays_4d_seeded
    from bevy_gaussian_splatting_tpu_torch.train.step import shifted_arrays

    if kind not in _RANK_SCENES:
        if kind == "3d":
            a = bench_arrays(N_GAUSSIANS, seed=0)
            _RANK_SCENES[kind] = (cloud_from_numpy(a, "cuda"), cloud_from_numpy(shifted_arrays(a), "cuda"))
        else:
            _RANK_SCENES[kind] = (cloud_from_numpy(random_arrays_4d_seeded(N_GAUSSIANS, seed=SEED_4D), "cuda"), None)
    return _RANK_SCENES[kind]


def _p22_counts() -> tuple:
    expand, fwd, bwd, red = train_counters()
    return expand.launches, dict(fwd.instances), bwd.launches, red.launches


def _p22_delta(before: tuple, key: tuple) -> dict:
    """Launches since ``before``, the forward compositor's of instantiation ``key``."""
    now = _p22_counts()
    return {"expand_pairs": now[0] - before[0],
            "composite_tiles_raw": now[1].get(key, 0) - before[1].get(key, 0),
            "composite_backward": now[2] - before[2], "segment_reduce": now[3] - before[3]}


def _p22_events_ms(fn, reps: int) -> float:
    """ms per run of ``fn`` between CUDA events on this rank's stream (the
    other ranks' work on the shared card and the collectives' host waits
    fall inside)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _p22_rows(mesh, n_total: int) -> slice:
    from bevy_gaussian_splatting_tpu_torch.parallel.render import TILES_AXIS

    n_local = n_total // mesh.shape[TILES_AXIS]
    band = mesh.get_local_rank(TILES_AXIS)
    return slice(band * n_local, (band + 1) * n_local)


def _p22_probe() -> dict:
    """Each collective the sharded path uses, on CUDA tensors with this
    world's backend -> what it returned, checked."""
    import torch.distributed as dist

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.full((3, 2), float(r), device="cuda")
    out = torch.empty((3 * w, 2), device="cuda")
    dist.all_gather_into_tensor(out, x)
    a2a = torch.empty((2 * w, 2), device="cuda")
    dist.all_to_all_single(a2a, torch.arange(4.0 * w, device="cuda").reshape(2 * w, 2) + 100 * r)
    s = torch.ones(2, device="cuda") * (r + 1)
    dist.all_reduce(s)
    m = torch.tensor([float(r)], device="cuda")
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    sent = torch.arange(4.0 * w).reshape(2 * w, 2)
    want = torch.cat([sent[2 * r : 2 * r + 2] + 100 * src for src in range(w)])
    ok = (torch.equal(out[:, 0].cpu(), torch.arange(w).repeat_interleave(3).float())
          and torch.equal(a2a.cpu(), want) and s[0].item() == w * (w + 1) / 2 and m.item() == w - 1)
    return {"backend": dist.get_backend(), "ok": bool(ok), "device": torch.cuda.get_device_name(0)}


def _p22_render(mode: str, exchange: str, repeat: bool = False) -> dict:
    """One sharded frame at 512x512 (the bounded exchange sized by
    ``plan_exchange(with_pairs=True)``), rank 0 held to the one-device
    ``render_tiled`` of the padded cloud, then PARALLEL_REPS timed frames."""
    import torch.distributed as dist

    from bevy_gaussian_splatting_tpu_torch.models.cloud import pad_cloud
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode, render_tiled
    from bevy_gaussian_splatting_tpu_torch.parallel.exchange import exchange_bytes_per_device
    from bevy_gaussian_splatting_tpu_torch.parallel.render import (
        make_mesh,
        make_sharded_render,
        plan_exchange,
        shard_cloud,
        shard_multiple,
    )

    settings = _p22_settings(mode)
    cloud, _ = _p22_scene("4d" if mode.startswith("4d") else "3d")
    width, height = PARALLEL_SIZE
    at = TIME_4D if mode.startswith("4d") else 0.0
    cam = orbit_camera(0.0, width, height, "cuda")
    mesh = make_mesh()
    n_bands = mesh.shape["tiles"]
    budget = pairs = None
    if exchange == "bounded":
        _, budget, pairs = plan_exchange(cloud, cam, settings, width, height, mesh, time=at, with_pairs=True)
    shard = shard_cloud(cloud, mesh)
    fn = make_sharded_render(mesh, settings, width, height, exchange=exchange, band_budget=budget, pairs_hint=pairs)
    key = (MODES[kernel_mode(settings)], False)
    before = _p22_counts()
    img = fn(shard, cam, time=at)
    again = fn(shard, cam, time=at) if repeat else None
    ms = _p22_events_ms(lambda: fn(shard, cam, time=at), PARALLEL_REPS)
    n_total = len(shard) * n_bands
    cols = 20 if mode == "2d" else 14
    out = {"rank": dist.get_rank(), "ms": ms, "launches": _p22_delta(before, key), "budget": budget,
           "band_pairs": pairs, "bytes": exchange_bytes_per_device(n_total, n_bands, cols, budget)}
    if dist.get_rank() == 0:
        ref = render_tiled(pad_cloud(cloud, shard_multiple(n_bands)), cam, settings, differentiable=False, time=at)
        d = (img - ref).abs()
        out.update(max_err=float(d.max()), diff_pixels=int((d > 0).any(dim=-1).sum()),
                   share_3e5=float((d > 3e-5).float().mean()), finite=bool(torch.isfinite(img).all()),
                   lit=float((img[..., :3].abs() > 1.0 / 255.0).any(dim=-1).float().mean()),
                   bitwise_repeat=same_bits(img, again) if repeat else None)
    return out


def _p22_reference_grads(padded, target_imgs, cams, settings) -> dict:
    """The one-device gradient of the mean squared error over ``cams``, each
    against its target, on the whole padded cloud."""
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.train.step import TrainableCloud

    model = TrainableCloud(padded)
    width, height = PARALLEL_SIZE
    loss = sum(torch.sum((render_tiled(model.cloud(), cam, settings) - t) ** 2) for cam, t in zip(cams, target_imgs))
    (loss / (len(cams) * height * width * 4)).backward()
    return {name: getattr(model, name).grad for name in model.fields}


def _p22_grad_rel(grads: dict, ref: dict, rows: slice) -> dict:
    """max |sharded - one-device| over this rank's rows, of each field's
    largest one-device magnitude (the whole cloud's)."""
    return {name: float((grads[name] - ref[name][rows]).abs().max() / ref[name].abs().max().clamp(min=1e-30))
            for name in grads}


def _p22_train(mode: str) -> dict:
    """One sharded training step (MSE towards the shifted scene's frame),
    its gradients against the one-device gradients of the same loss, then
    PARALLEL_REPS timed steps."""
    import torch.distributed as dist

    from bevy_gaussian_splatting_tpu_torch.models.cloud import pad_cloud
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode, render_tiled
    from bevy_gaussian_splatting_tpu_torch.parallel.render import make_mesh, make_train_step, shard_cloud, shard_multiple

    settings = _p22_settings(mode)
    cloud, target_cloud = _p22_scene("3d")
    width, height = PARALLEL_SIZE
    cam = orbit_camera(0.0, width, height, "cuda")
    mesh = make_mesh()
    mult = shard_multiple(mesh.shape["tiles"])
    with torch.no_grad():
        target = render_tiled(pad_cloud(target_cloud, mult), cam, settings, differentiable=False)
    step, init = make_train_step(mesh, settings, width, height, learning_rate=TRAIN_LR)
    state = init(shard_cloud(cloud, mesh))
    key = (MODES[kernel_mode(settings)], False)
    before = _p22_counts()
    loss = float(step(state, cam, target))
    grads = {name: getattr(state.model, name).grad.clone() for name in state.model.fields}
    ms = _p22_events_ms(lambda: step(state, cam, target), PARALLEL_REPS)
    launches = _p22_delta(before, key)
    padded = pad_cloud(cloud, mult)
    rel = _p22_grad_rel(grads, _p22_reference_grads(padded, [target], [cam], settings), _p22_rows(mesh, len(padded)))
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    return {"rank": dist.get_rank(), "loss": loss, "rel": rel, "finite": finite, "ms": ms, "launches": launches}


def _p22_multicam() -> dict:
    """A (camera 2, tiles 2) frame of two orbit poses against the one-device
    frames, and one multi-camera training step's gradients against the
    one-device gradients of the mean over both views."""
    import torch.distributed as dist

    from bevy_gaussian_splatting_tpu_torch.models.cloud import pad_cloud
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.parallel.render import (
        make_mesh,
        make_sharded_render_multicam,
        make_train_step_multicam,
        shard_cloud,
        shard_multiple,
    )

    settings = _p22_settings("obb")
    cloud, target_cloud = _p22_scene("3d")
    width, height = PARALLEL_SIZE
    cams = [orbit_camera(az, width, height, "cuda") for az in PARALLEL_AZ]
    mesh = make_mesh(camera_parallel=2)
    mult = shard_multiple(mesh.shape["tiles"])
    padded = pad_cloud(cloud, mult)
    shard = shard_cloud(cloud, mesh)
    with torch.no_grad():
        refs = [render_tiled(padded, cam, settings, differentiable=False) for cam in cams]
        targets = torch.stack([render_tiled(pad_cloud(target_cloud, mult), cam, settings, differentiable=False)
                               for cam in cams])
    before = _p22_counts()
    imgs = make_sharded_render_multicam(mesh, settings, width, height)(shard, cams)
    err = max(float((imgs[i] - refs[i]).abs().max()) for i in range(len(cams)))
    bitwise = all(same_bits(imgs[i], refs[i]) for i in range(len(cams)))
    step, init = make_train_step_multicam(mesh, settings, width, height, learning_rate=TRAIN_LR)
    state = init(shard)
    loss = float(step(state, cams, targets))
    launches = _p22_delta(before, ("obb", False))
    grads = {name: getattr(state.model, name).grad for name in state.model.fields}
    rel = _p22_grad_rel(grads, _p22_reference_grads(padded, list(targets), cams, settings),
                        _p22_rows(mesh, len(padded)))
    return {"rank": dist.get_rank(), "err": err, "bitwise": bitwise, "loss": loss, "rel": rel,
            "launches": launches, "mesh": mesh.shape}


def _p22_work_ratio(exchange: str) -> dict:
    """``scaling.measured_work_ratio`` of the OBB frame: the ranks' device
    time (profiler) over one rank's frame of the whole cloud."""
    from bevy_gaussian_splatting_tpu_torch.parallel.render import make_mesh, plan_exchange
    from bevy_gaussian_splatting_tpu_torch.parallel.scaling import measured_work_ratio

    settings = _p22_settings("obb")
    cloud, _ = _p22_scene("3d")
    width, height = PARALLEL_SIZE
    cam = orbit_camera(0.0, width, height, "cuda")
    mesh = make_mesh()
    budget = pairs = None
    if exchange == "bounded":
        _, budget, pairs = plan_exchange(cloud, cam, settings, width, height, mesh, with_pairs=True)
    return measured_work_ratio(cloud, cam, settings, width, height, mesh, iters=3, exchange=exchange,
                               band_budget=budget, pairs_hint=pairs)


def phase_parallel(launches: dict) -> None:
    """Phase 22: a gloo world of PARALLEL_RANKS ranks sharing the card, then
    a NCCL world of one rank (this process).  Adds the band path's launches
    to ``launches[mode]``."""
    import tempfile

    import torch.distributed as dist

    from bevy_gaussian_splatting_tpu_torch.models.cloud import pad_cloud
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import render_tiled
    from bevy_gaussian_splatting_tpu_torch.parallel import distributed as pdist
    from bevy_gaussian_splatting_tpu_torch.parallel.render import make_mesh, make_sharded_render, shard_cloud

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    def add(mode: str, counts: dict) -> None:
        for name, v in counts.items():
            launches[mode][name] += v

    log("[parallel] four ranks sharing one card measure work, not scaling: their frames and steps "
        "time-share the card, and gloo moves every exchange through host memory")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with pdist.World(PARALLEL_RANKS, "gloo", "file://" + tmp + "/gloo", device="cuda:0",
                         timeout_s=600.0) as world:
            log(f"[parallel] gloo world of {PARALLEL_RANKS} ranks on cuda:0 up in {time.perf_counter() - t0:.2f} s")
            probe = world.run(_p22_probe)
            if not all(p["ok"] for p in probe):
                raise AssertionError(f"gloo collectives on CUDA tensors: {probe}")
            log("[parallel] gloo on CUDA tensors: all_gather_into_tensor, all_to_all_single, all_reduce "
                "(sum, max) checked on every rank")
            for mode in ("obb", "aabb", "2d", "4d-obb"):
                for exchange in ("allgather", "bounded"):
                    if mode == "4d-obb" and exchange == "bounded":
                        continue
                    t0 = time.perf_counter()
                    out = world.run(_p22_render, mode, exchange, mode == "obb" and exchange == "allgather")
                    r0 = out[0]
                    for o in out:
                        add(mode, o["launches"])
                    if not (r0["finite"] and r0["lit"] >= LIT_FLOOR):
                        raise AssertionError(f"[parallel {mode} {exchange}] frame not finite or unlit: {r0}")
                    if mode == "4d-obb":
                        bar, share, top = PARALLEL_4D_BARS
                        ok = r0["share_3e5"] < share and r0["max_err"] < top
                        bar_text = f"share past {bar:g} {r0['share_3e5']:.3g} (< {share}), max {r0['max_err']:.3g}"
                    else:
                        ok = r0["max_err"] <= PARALLEL_BAR[mode]
                        bar_text = f"max |sharded - one device| {r0['max_err']:.3g} (bar {PARALLEL_BAR[mode]:g})"
                    same = "bitwise" if r0["diff_pixels"] == 0 else (
                        f"NOT bitwise: {r0['diff_pixels']} of {PARALLEL_SIZE[0] * PARALLEL_SIZE[1]} pixels differ")
                    log(f"[parallel {mode} {exchange} {PARALLEL_SIZE[0]}x{PARALLEL_SIZE[1]}] {bar_text}; {same}"
                        + (f"; same-seed repeat {'bitwise' if r0['bitwise_repeat'] else 'NOT bitwise'}"
                           if r0["bitwise_repeat"] is not None else "")
                        + f"; budget {r0['budget']}, band pairs {r0['band_pairs']}; exchange bytes received per "
                        f"rank {r0['bytes']}; CUDA-event ms per frame by rank "
                        + ", ".join(f"{o['ms']:.3f}" for o in out)
                        + f"; launches {sum(o['launches']['composite_tiles_raw'] for o in out)} compositor, "
                        f"{sum(o['launches']['expand_pairs'] for o in out)} expansion; {time.perf_counter() - t0:.2f} s")
                    if not ok or r0["diff_pixels"] != 0 or (r0["bitwise_repeat"] is False):
                        raise AssertionError(f"[parallel {mode} {exchange}] failed: {r0}")
            for mode in ("obb", "aabb"):
                out = world.run(_p22_train, mode)
                for o in out:
                    add(mode, o["launches"])
                worst = {k: max(o["rel"][k] for o in out) for k in out[0]["rel"]}
                log(f"[parallel train {mode} {PARALLEL_SIZE[0]}x{PARALLEL_SIZE[1]}] loss {out[0]['loss']:.6g}; "
                    f"gradients vs one device, max rel by field {json.dumps(worst)} (bar {PARALLEL_GRAD_REL:g}); "
                    "CUDA-event ms per step by rank " + ", ".join(f"{o['ms']:.3f}" for o in out)
                    + f"; launches {json.dumps({k: sum(o['launches'][k] for o in out) for k in out[0]['launches']})}")
                if not all(o["finite"] for o in out) or max(worst.values()) > PARALLEL_GRAD_REL:
                    raise AssertionError(f"[parallel train {mode}] gradients off: {worst}")
                if any(o["launches"][k] <= 0 for o in out for k in o["launches"]):
                    raise AssertionError(f"[parallel train {mode}] a kernel did not launch: {out}")
            out = world.run(_p22_multicam)
            for o in out:
                add("obb", o["launches"])
            worst = {k: max(o["rel"][k] for o in out) for k in out[0]["rel"]}
            log(f"[parallel multicam {out[0]['mesh']}] frames vs one device max {out[0]['err']:.3g} (bar "
                f"{PARALLEL_BAR['obb']:g}), {'bitwise' if out[0]['bitwise'] else 'NOT bitwise'}; step loss "
                f"{out[0]['loss']:.6g}, gradients max rel by field {json.dumps(worst)} (bar {PARALLEL_GRAD_REL:g})")
            if (out[0]["err"] > PARALLEL_BAR["obb"] or not out[0]["bitwise"]
                    or max(worst.values()) > PARALLEL_GRAD_REL):
                raise AssertionError(f"[parallel multicam] off: {out[0]['err']}, {worst}")
            for exchange in ("allgather", "bounded"):
                out = world.run(_p22_work_ratio, exchange)
                ratio = out[0]
                log(f"[parallel work ratio obb {exchange}] sum of the {PARALLEL_RANKS} ranks' device ms per frame "
                    f"{ratio[PARALLEL_RANKS]:.3f} / one rank's on the whole cloud {ratio[1]:.3f} = "
                    f"{ratio['work_ratio']:.3f} (profiler: kernels and copies)")
        # the NCCL world of one: this process, its own card
        t0 = time.perf_counter()
        pdist.initialize("file://" + tmp + "/nccl", 1, 0, "nccl", "cuda")
        try:
            mesh = make_mesh()
            cloud, _ = _p22_scene("3d")
            width, height = PARALLEL_SIZE
            cam = orbit_camera(0.0, width, height, "cuda")
            for mode in ("obb", "aabb", "2d"):
                settings = _p22_settings(mode)
                before = _p22_counts()
                img = make_sharded_render(mesh, settings, width, height)(shard_cloud(cloud, mesh), cam)
                add(mode, _p22_delta(before, (mode, False)))
                ref = render_tiled(pad_cloud(cloud, 256), cam, settings, differentiable=False)
                log(f"[parallel nccl 1 rank {mode}] sharded frame vs render_tiled "
                    f"{'bitwise' if same_bits(img, ref) else 'NOT bitwise'}, max {float((img - ref).abs().max()):.3g}")
                if not same_bits(img, ref):
                    raise AssertionError(f"[parallel nccl {mode}] one band is not render_tiled bitwise")
            # NCCL refuses two ranks on one card (the rendezvous store names each rank's card)
            store = dist.HashStore()
            store.set("bgs_card/1", f"{__import__('socket').gethostname()}/"
                                    f"{torch.cuda.get_device_properties(0).uuid}")
            try:
                pdist._check_devices(store, 2, 0, torch.device("cuda", 0))
                raise AssertionError("two ranks on one card were not refused")
            except ValueError as exc:
                log(f"[parallel nccl] two ranks on one card refused: {exc}")
        finally:
            dist.destroy_process_group()
        _RANK_SCENES.clear()
        log(f"[parallel nccl] {time.perf_counter() - t0:.2f} s")
    log(f"[parallel] phase {time.perf_counter() - t_phase:.2f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true", help="write a per-kernel breakdown to chiprun_out/")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: drives one card, {torch.cuda.device_count()} are visible "
              "(set CUDA_VISIBLE_DEVICES to one)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bevy_gaussian_splatting_tpu_torch.models.cloud import cloud_from_numpy, random_arrays_4d_seeded
    from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings, GaussianMode
    from bevy_gaussian_splatting_tpu_torch.ops.cuda.tile_fwd import MODES
    from bevy_gaussian_splatting_tpu_torch.ops.rasterize_tile import kernel_mode
    from bevy_gaussian_splatting_tpu_torch.train.step import shifted_arrays

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()

    t0 = time.perf_counter()
    arrays = bench_arrays(N_GAUSSIANS, seed=0)
    cloud = cloud_from_numpy(arrays, "cuda")
    target_cloud = cloud_from_numpy(shifted_arrays(arrays), "cuda")
    log(f"[scene] {len(cloud)} gaussians on {cloud.device} in {time.perf_counter() - t0:.2f} s")

    # per mode: the kernels' measurements at 512x512 and the launches of the
    # paths driven in that mode (serving frames, then training steps); the
    # overlay's ("<mode>+bbox") from its own serving frames
    results, launches = {}, {}
    modes = (CloudSettings(), CloudSettings(aabb=True), CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_2D))
    for settings in modes:
        mode = MODES[kernel_mode(settings)]
        for width, height in SIZES:
            res = timed(f"kernels {mode} {width}x{height}", phase_kernels, cloud, target_cloud, settings, width, height)
            if (width, height) == SIZES[0]:
                results[mode] = res
                # the overlay's frames bin as the mode's: the same expansion inputs
                results[mode + "+bbox"] = {"composite_tiles_raw": res["composite_tiles_raw+bbox"],
                                           "expand_pairs": res["expand_pairs"]}
        if mode == "aabb":
            timed("kernels aabb converge", phase_kernels_converge)
        timed(f"small {mode}", phase_small, settings)
        if mode == "obb":
            timed("small views", phase_small_views)
        serve = timed(f"main {mode}", phase_main, cloud, settings, opts.profile)
        # the replay frames of the serving layer count with the mode's frames
        replay = timed(f"serve {mode}", phase_serve, cloud, settings)
        serve = {k: v + replay[k] for k, v in serve.items()}
        if mode == "obb":
            timed("orbit keys", phase_orbit_keys, cloud)
            multi = timed("multi-camera", phase_multi_camera, cloud)
            serve = {k: v + multi[k] for k, v in serve.items()}
            timed("background", phase_background, cloud)
        launches[mode + "+bbox"] = timed(f"main {mode}+bbox", phase_main, cloud,
                                         settings.replace(visualize_bounding_box=True), False, rounds=1)
        if mode == "aabb":
            train = timed("train aabb", phase_train_aabb, arrays, settings, opts.profile)
            converge = timed("converge", phase_converge)
            train = {k: v + converge[k] for k, v in train.items()}
        elif mode == "2d":
            train = timed("train 2d", phase_train, arrays, settings, SURFEL_TRAIN_STEPS, False, opts.profile)
            timed("surface 2d", phase_surface, arrays)
        else:
            timed("main views", phase_main_views, cloud)
            train = timed("train obb", phase_train, arrays, settings, TRAIN_STEPS, True, opts.profile)
            normal = timed("train normal", phase_train_normal, arrays)
            train = {k: v + normal[k] for k, v in train.items()}
        launches[mode] = {k: serve.get(k, 0) + v for k, v in train.items()}

    # the other cloud flavours on the same scene and path (OBB): their frames
    # count with the OBB mode's
    flavours = timed("flavours", phase_flavours, arrays)
    launches["obb"] = {k: v + flavours.get(k, 0) for k, v in launches["obb"].items()}
    # cloud and scene files, scene rendering, query, morph and noise (OBB): their frames count with OBB's
    files = timed("io", phase_io, cloud, arrays)
    launches["obb"] = {k: v + files.get(k, 0) for k, v in launches["obb"].items()}
    # streaming, checkpoints, the trace, the CLIs and the viewer (OBB): their frames and steps count with OBB's
    front = timed("front ends", phase_front_ends, cloud, arrays)
    launches["obb"] = {k: v + front.get(k, 0) for k, v in launches["obb"].items()}

    # 4DGS, which bins and composites as OBB or AABB: the JAX bench's scene
    t0 = time.perf_counter()
    arrays4 = random_arrays_4d_seeded(N_GAUSSIANS, seed=SEED_4D)
    cloud4 = cloud_from_numpy(arrays4, "cuda")
    log(f"[scene 4d] {len(cloud4)} gaussians (random_gaussians_4d_seeded, seed {SEED_4D}) in "
        f"{time.perf_counter() - t0:.2f} s")
    timed("project", phase_project, cloud, cloud4)
    timed("sh", phase_sh, cloud, cloud4)
    timed("project train", phase_project_train, cloud)
    for aabb in (False, True):
        settings = CloudSettings(gaussian_mode=GaussianMode.GAUSSIAN_4D, aabb=aabb, time=TIME_4D)
        mode = "4d-" + MODES[kernel_mode(settings)]
        for width, height in SIZES:
            res = timed(f"kernels {mode} {width}x{height}", phase_kernels, cloud4, None, settings, width, height,
                        target_time=TARGET_TIME_4D)
            if (width, height) == SIZES[0]:
                results[mode] = res
                results[mode + "+bbox"] = {"composite_tiles_raw": res["composite_tiles_raw+bbox"],
                                           "expand_pairs": res["expand_pairs"]}
        timed(f"small {mode}", phase_small_4d, settings)
        serve, overlay = timed(f"main {mode}", phase_main_4d, cloud4, settings, opts.profile)
        if not aabb:
            sweep = timed(f"serve {mode}", phase_serve_4d, cloud4, settings)
            serve = {k: v + sweep[k] for k, v in serve.items()}
        train = timed(f"train {mode}", phase_train_4d, arrays4, settings, opts.profile)
        launches[mode] = {k: serve.get(k, 0) + v for k, v in train.items()}
        launches[mode + "+bbox"] = overlay

    del cloud4
    timed("examples", phase_examples)
    # multi-rank band rendering and training: the band launches count with their modes'
    timed("parallel", phase_parallel, launches)

    kernels = []
    sources = {
        "expand_pairs": ("bevy_gaussian_splatting_tpu_torch/csrc/expand.cu",
                         "bevy_gaussian_splatting_tpu/ops/pallas/expand.py:76"),
        "composite_tiles_raw": ("bevy_gaussian_splatting_tpu_torch/csrc/tile_fwd.cu",
                                "bevy_gaussian_splatting_tpu/ops/pallas/tile_fwd.py:237"),
        "composite_backward": ("bevy_gaussian_splatting_tpu_torch/csrc/tile_bwd.cu",
                               "bevy_gaussian_splatting_tpu/ops/pallas/tile_bwd.py:188"),
        "segment_reduce": ("bevy_gaussian_splatting_tpu_torch/csrc/reduce.cu",
                           "bevy_gaussian_splatting_tpu/ops/pallas/reduce.py:39"),
    }
    # the four kernels in OBB, AABB and 2DGS mode (the reduce at 16 columns
    # in 2DGS), and the forward compositor's overlay instantiation (its
    # bbox=True branch, tile_fwd.py:289-312) and the expansion in each mode's
    # overlay frames, each with the launches of its own paths
    # then the same for 4DGS frames and steps (modes "4d-obb", "4d-aabb")
    three, four = ("obb", "aabb", "2d"), ("4d-obb", "4d-aabb")
    entries = [
        (name, mode) for group in (three, four) for mode, name in (
            [(m, k) for m in group for k in sources]
            + [(f"{m}+bbox", k) for m in group for k in ("expand_pairs", "composite_tiles_raw")]
        )
    ]
    for name, mode in entries:
        source, replaces = sources[name]
        n_launch = launches[mode][name]
        if n_launch <= 0:
            raise AssertionError(f"{name} ({mode}) was never launched on the main path")
        r = results[mode][name]
        kernels.append({
            "name": name, "mode": mode, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n_launch, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    smi = card_name_and_limit()
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
