#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, ``sm_90a``).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: ``nvcc`` compiles ``orb_slam3_noted_tpu_torch/csrc/*.cu`` for
   ``sm_90a`` (time and ``ptxas -v`` output);
3. kernels against their plain PyTorch versions on the card, on lap frame
   0's pair: K1 FAST corner candidates, K2 7-tap blur and K3 rBRIEF, one
   launch each over the pyramid atlas of a 752x480 frame (8 levels, 1,182
   cells, the 1200 detected keypoints), for one image (B = 1) and the
   stacked pair (B = 2), plus their single-level forms (K1's is the dense
   score map of each level); K1 and K3 must agree exactly, K2 within
   ``K2_ATOL``.  K4 stereo SAD on the atlases of both pyramids, the 1200
   left keypoints and their Hamming candidates, and again with those
   centres on atlases of uniform noise; within ``K4_ATOL`` and the same
   best shift for ``K4_ARGMIN_SHARE`` of the keypoints.  Every kernel gets
   three times: its device time (the kernel's own duration from
   ``torch.profiler``; this is ``ms``), its per-call time (CUDA events
   around one wrapper call: the host path with the device waiting) and its
   host enqueue time; the plain version and the one PyTorch library call
   that computes the same function where there is one (K2: reflect pad +
   two ``conv2d`` per level) get device and per-call times; each kernel's
   bound on this card follows from the bytes it must move and the
   operations it must do, and stands beside ``launch_floor_ms``, the device
   time of an empty kernel timed the same way (the least any launch lasts);
4. the RGB-D lap: ``RGBDSLAM`` in localisation mode on ``cuda`` over 48
   frames of the stereo bench configuration (every lap renders its frames
   from the JAX run's camera rotations, stored in its fixture), launch
   counts per frame 1 for
   K1, K2 and K3, 0 for K4, tracked frames and metric RMSE against
   ground truth
   within the thresholds derived from the JAX package's run of the same lap
   (``tests/fixtures/rgbd_localization_lap.json``), and every frame's state
   and position within ``POS_TOL_M`` of that run;
5. the stereo lap: ``StereoSLAM`` on ``cuda`` over the 48 rectified pairs
   of the same trajectory, full SLAM (keyframe insertion, local BA), launch
   counts per frame 1 for each of K1 to K4 (the pair is one batch of two), and tracked frames,
   RMSE, keyframe count and the initial map's size within the thresholds
   derived from the JAX package's run
   (``tests/fixtures/stereo_slam_lap.json``);
6. batch shapes: K1, K2 and K3 over the atlas of the mono lap's first 16
   frames (B = 16) and over the 32 images of the first 16 stereo pairs (B =
   32, a stereo batch dispatch), K4 over those 16 pairs, against their
   plain versions to the same limits, timed three ways beside their bounds;
7. the mono lap: ``bench.py``'s monocular configuration (8192 map points,
   loop closing on, as ``bench.py`` runs it, ``flush()`` at the end), 120 frames of ``orbit_trajectory(120, forward=0.03,
   yaw0=0.45)`` (rendered from the JAX run's camera rotations, stored in
   the fixture) staged on the card once, ``MonoSLAM.process_batch`` in
   batches of 16 from frame 0 (batched two-view initialisation included) on
   the JAX run's RANSAC minimal sets (stored in the fixture):
   initialisation frame, tracked frames, Sim(3)-aligned ATE, keyframes and
   loops closed against ``tests/fixtures/mono_slam_lap.json``, K1, K2 and K3 launched
   once per extraction dispatch (each batch of tracking, each batch of
   initialisation attempts) and K4 never, frames/s;
8. the stereo batch lap: the 48 pairs staged on the card, ``process`` until
   initialised, then ``process_batch`` in batches of 16, loop closing on and
   ``flush()`` at the end, against
   ``tests/fixtures/stereo_batch_lap.json``; K4 once per batch plus once
   per frame-by-frame frame, frames/s;
9. the kidnapped monocular lap (``bench.py``'s monocular configuration,
   ``MonoSLAM.process`` frame by frame, loop closing off): frames 0-35 of
   the mono lap's trajectory, three blank frames, then frames 20-59 with the
   camera rolled 90 deg about its optical axis, on the JAX run's two-view
   and PnP draws, against ``tests/fixtures/mono_reloc_lap.json``: each
   relocalisation at most a frame after the JAX run's, to the same
   candidate keyframe, PnP inliers at least half the JAX run's, as many
   relocalisations,
   tracked frames, Sim(3) ATE over the frames that are not blank and
   keyframes as on the mono lap, the relocalisation database built with
   one BoW row per keyframe the mapper inserted, ``final_poses()`` one
   finite pose a frame, K1, K2 and K3 once a frame (blank frames included)
   and K4 never; ms per relocalisation attempt, one keyframe's BoW
   transform (device and per-call ms beside its bound) and frames/s;
10. loop closing.  (a) ``bench.py``'s 400-frame accuracy lap
   (``bench.py:215-309``: a pendulum that leaves the start twice and comes
   back), cut to its first 200 frames (one excursion each way and back to
   the start) to keep the run's time, at the monocular configuration,
   frames rendered from the JAX run's
   camera poses and staged on the card once, ``process_batch`` in batches
   of 16 with ``bench.py``'s keyframe override and ``flush()`` at the end,
   once with loop closing off (``_maybe_close_loop`` is
   ``_register_reloc_kf``) and once on, then a third arm with loop closing
   on and 1.4 m excursions instead of 0.7 over all 400 frames (the JAX
   package closes a loop there, on ``bench.py``'s lap none), each arm on
   the JAX run's two-view
   draws and, where the pair masks agree, its Sim(3) RANSAC draws, held to
   ``tests/fixtures/mono_loop_lap.json``: initialisation frame, tracked
   frames, Sim(3)-aligned ATE over the tracked frames, loops closed (at
   least the JAX run's, each of its loops found again: the candidate's
   frame within 16, the current keyframe's no later than the JAX run's +
   16; each loop's distance from the true relative pose reported), keyframe
   insertions, one detection per keyframe inserted after initialisation,
   K1-K3 once per extraction dispatch and K4 never; it
   prints ``bench.py``'s loop-ATE line for those 200 frames
   (``mono_200f_loop_ate``), frames/s, batch
   latency (p50, max) and host ms per detection drain.  (b) a full-width
   loop correction: the drifted map of ``scripts/loop_scaffold.py`` (64
   keyframes, 1200 features a keyframe, 2400 map points, the tail 0.3 /
   -0.1 / 0.2 m from keyframe 0) on the card, ``LoopCloser`` on the 32k-word
   vocabulary with camera context (RANSAC, ``sim3_refine``, the pose graph,
   the deferred fuses, the time-sliced GBA and its merge), held to
   ``tests/fixtures/loop_correction_full.json`` (the loop (63, 0), its
   scale, the corrected points, the keyframe poses); ms per step with the
   card synchronised, the first correction apart from the rest, and the
   kernel launches of one correction;
11. visual-inertial SLAM.  (a) ``bench.py``'s stereo-inertial lap
   (``bench.py:146-212``): 240 pairs of ``smooth_pose`` at 20 fps rendered
   from the JAX run's camera poses and staged on the card once, the JAX
   run's 200 Hz IMU samples, ``cfg_vi``'s values,
   ``StereoInertialSLAM.process_batch`` in batches of 16 from frame 0, loop
   closing on, ``flush()`` at the end, held to
   ``tests/fixtures/stereo_inertial_lap.json``: tracked frames, the final
   ``imu_stage`` and the batch each stage is reached in, SE(3)-aligned ATE
   and the Sim(3) scale, the first IMU init's gravity direction, keyframe
   insertions, loops closed, K1-K4 once per extraction dispatch; it prints
   ``bench.py``'s ``stereo_inertial_tracked_fps_752x480_1200feat`` line
   (this first pass), batch latency (p50, max), the final biases beside
   the JAX run's and host ms by stage (``vi_frontend_batch``,
   ``vi_track_batch``, ``insert_keyframe``, ``chain_ba``, ``imu_init``,
   ``loop_drain``).  (b) one 4-DoF loop correction at full width: the
   drifted 64-keyframe map of ``scripts/loop_scaffold.py`` with the
   essential graph of an inertial map through ``optimize_pose_graph_4dof``,
   held to ``tests/fixtures/loop_4dof_full.json`` (poses, every keyframe's
   roll and pitch unchanged), ms per call, the first apart;
12. fisheye stereo at TUM-VI's 512x512 (``TUM_512.yaml``'s two
   Kannala-Brandt cameras, the right one rotated against the left, 1500
   features): 100 pairs of a hand-held motion at 20 fps rendered by the
   port's ``render_fisheye`` from the JAX run's camera poses.  (a)
   ``FisheyeStereoSLAM.process`` frame by frame, loop closing off, held to
   ``tests/fixtures/fisheye_stereo_lap.json``: tracked frames, ATE with the
   first pose's offset removed (and after SE(3) alignment, reported),
   keyframes, the initial map, frame 0's fisheye stereo matches (their
   median relative depth error reported), K1, K2 and K3 once a frame and
   K4 never; frames/s, and kernel launches and host ms a frame by stage
   (extraction, fisheye matching, the mapper, the rest) from a profiled
   window of a second run.  (b) ``FisheyeStereoInertialSLAM.process`` on
   the same pairs with the JAX run's 200 Hz IMU samples, held to
   ``tests/fixtures/fisheye_inertial_lap.json``: tracked frames, the final
   ``imu_stage`` and the frame each stage is reached at, the first IMU
   init's gravity, SE(3) ATE, keyframe insertions, K1-K3 once a frame;
   frames/s and host ms by stage; then its first 16 frames through
   ``process_batch``, whose records must equal those of ``process``.  (c)
   K1, K2 and K3 over the atlas of frame 0's fisheye pair (B = 2) against
   their plain versions, timed three ways beside their bound (K2 also
   beside reflect pad + ``conv2d``; keys ``*_fisheye_pair``);
13. the Atlas, frame by frame, on the JAX runs' two-view draws and, where
   the pair masks agree, their merge draws (``AtlasSLAM._merge_sets``).
   (a) ``AtlasSLAM(MonoSLAM)`` at ``bench.py``'s monocular configuration,
   loop closing on: 48 frames of the 120-frame orbit, 11 blank frames (the
   map switch), a revisit of poses 16-71 (a new map, merged back), held to
   ``tests/fixtures/atlas_lap.json``: maps and merges, the merge's frame,
   slot, candidate and RANSAC inliers, its world transform against JAX's
   and the truth, keyframes, tracked frames, Sim(3) ATE, a query at pose
   2's view retrieving a pre-merge keyframe, K1-K3 once a frame and K4
   never; frames/s, ms and kernel launches of the merge.  (d) the active
   system's checkpoint right after the merge (``io/checkpoint.py``; its
   keys, dtypes and shapes those of the JAX run's), restored into a fresh
   ``MonoSLAM`` on the card and run over the next 16 frames beside the
   original: records equal.  (b) ``AtlasSLAM(StereoSLAM, fix_scale=True)``
   at ``bench.py``'s stereo configuration: poses 0-99, ``on_sequence_end()``,
   poses 40-89, held to ``stereo_atlas_lap.json``: one merge at scale 1
   within 0.1 degrees and 5 mm of JAX's, tracked frames, SE(3) ATE, K1-K4
   once a frame.  (c) ``InertialAtlasSLAM(MonoInertialSLAM)`` on
   ``tests/test_inertial_atlas.py``'s trajectory and settings at 752x480
   and 1200 features, the camera pitched to the floor while the lens is
   covered (map B IMU-initialises there), with the JAX run's 200 Hz IMU
   samples, held to ``inertial_atlas_lap.json``: map A's IMU stage frame,
   the switch, the merge of two metric maps at scale 1 about gravity alone
   (the JAX package tilts it: ROADMAP Queue 3), the welded chain (one
   invalid junction segment), tracked frames after the merge, SE(3) ATE,
   K1-K3 once a frame;
14. the offline driver: three dataset layouts written by
   ``scripts/cli_layouts.py`` with the port's ``io.images.write_png`` under
   ``build/cli_layouts/``, each run through ``cli.main`` in this process on
   the card, with ``--eval --metrics``, and held to the JAX package's CLI
   on the same files (``tests/fixtures/cli_*.json``): the parsed settings
   equal, tracked >= JAX - 2, keyframes +-2, the CLI's ATE <= 2 x JAX + 2
   mm, ``imu_stage`` equal, a trajectory row per record, a metric line per
   dispatch and a final one, K1-K3 (K4 in 14a) once per extraction
   dispatch.  (a) EuRoC layout (``EuRoC.yaml``'s schema), ``--mode
   stereo-inertial --batch 16 --times``: 80 pairs of ``bench.py``'s
   stereo-inertial lap at 752x480, 1200 features (phase 11's renders), with
   its 200 Hz IMU rows,
   the images warped to raw cameras with rad-tan distortion and a
   rectifying rotation, rectified on the card by the CLI (the remap's
   device and per-call ms reported).  (b) TUM RGB-D layout (``TUM1.yaml``),
   ``--mode rgbd --checkpoint-out``: 32 RGB PNGs at 640x480 (1000
   features) with 16-bit depth at scale 5000, the depth stamps ~10 ms off
   and one missing (31 frames associate); the npz's keys and dtypes as the
   JAX CLI's.  (c) TUM-VI layout (``TUM_512.yaml``), ``--mode
   stereo-inertial``, routed to ``fisheye-stereo-inertial`` by Camera2: 64
   pairs of phase 12b's motion and IMU at 512x512, 1500 features (phase
   12's renders).  Each
   reports frames/s (the CLI's), decode ms a frame (the loader's reader and
   prefetcher over the layout);
15. the live node (``node.SlamNode`` and ``serve``) over a TCP socket on
   127.0.0.1, ``serve`` in a thread and the producer in this one, held to
   the JAX package's node run in process on the same frames
   (``tests/fixtures/node_*.json``, ``scripts/torch_port_reference_lap.py
   --mode node_stereo_inertial|node_rgbd``).  (a) ``stereo-inertial`` at
   phase 11's configuration: its first 80 pairs, each frame one IMUS block
   (the 200 Hz samples up to the frame's time, from offset 4 as the
   protocol documents), IMG0 and IMG1, then its POSE before the next
   frame: 80 POSE records and FINI, tracked >= JAX - 2, the SE(3) ATE of
   the published ``twc`` <= 2 x JAX + 2 mm, ``imu_stage`` equal, keyframes
   +-2, K1-K4 80 launches each; round trip (IMG0 sent to POSE received)
   p50 / p95 / max with the first frame apart, frames/s.  (b) ``rgbd`` at
   the stereo bench configuration, the mapper on, phase 4's 48 frames as
   IMG0 + DPT1 (f32 depth) lock-step, ``keep_frame_overlay`` on and a
   ``LiveViewer`` on the same system: after frames 24 and 48
   ``/state.json`` (its counts those of the map) and ``/frame.png``
   (decoded by the port's reader: ``draw_frame`` of the last frame),
   tracked >= JAX - 2, RMSE <= 2 x JAX + 2 mm, keyframes +-1, the overlay's
   matched keypoints on the last frame >= 90% of JAX's, ``export_map_html``
   embedding ``map_snapshot``'s dict, ``save_map_png`` decoding, K1-K3 48
   and K4 0; ms of each request, of ``save_map_png`` and
   ``export_map_html``, each frame's round trip and frames/s over them.  (c) ``stereo`` with ``realtime`` (the backlog
   dropped to the newest frame), phase 5's 48 pairs sent at 20 frames/s
   without waiting: published + dropped = 48, FINI's ``n_frames`` the
   published count, POSE times increasing, no exception in the worker,
   K1-K4 once per published frame; tracked, drops, round trip;
16. distribution (``parallel/dist_ba.py``, ``scripts/torch_port_dist.py``),
   each run against its one-device counterpart in this process: (a) the
   full-capacity GBA of the JAX package's multi-device dry run (256
   keyframes, 16,384 points, 307,200 observations) through
   ``distributed_global_ba`` at ``DIST_GBA_ITERS``, poses within
   ``DIST_GBA_POSE_TOL``, median point distance <= ``DIST_GBA_POINT_M``,
   cost finite and within 1%; (b) its 256-keyframe Sim(3) pose graph (~1,700
   edges) through ``distributed_pose_graph_sim3`` within ``DIST_PG_TOL``;
   both on a one-rank NCCL group in this process and on two ranks sharing
   the card over gloo with CUDA tensors, spawned once with (c) the loop
   closer on phase 10b's full-width drifted map in that 2-rank group: its
   sharded pose graph and sharded GBA each called once, the poses within
   ``DIST_LOOP_PG_TOL`` of the one-device correction after the graph and
   within ``DIST_LOOP_GBA_TOL`` of ``run_global_ba`` with the same counts
   after the GBA, the median corrected point <= ``CORR_POINT_M`` from the
   truth; the two ranks' results equal bit for bit.  ms a call at each
   world size (two ranks on one card are the protocol's cost, not
   scaling), collectives a call and the phase's seconds;
17. the batch modes of RGB-D and fisheye stereo at B = 16 (the JAX
   package's facades inherit the rectified stereo hooks there; the port's
   run the front ends of their ``process``): (a) phase 12's 100 pairs
   (not rendered again) through ``FisheyeStereoSLAM.process_batch``, frame
   0 through ``process``, loop closing off as in 12a, held to the JAX run
   frame by frame (``fisheye_stereo_lap.json``): tracked >= JAX - 2, ATE
   with the first pose's offset removed <= 2 x JAX + 2 mm, keyframes +-2,
   second-camera rows in the keyframes (``kf_xy_r``) >= 90% of 12a's;
   (b) phase 4's 48 frames with their depth maps through
   ``RGBDSLAM.process_batch`` with the mapper, held to the JAX run frame by
   frame (``node_rgbd.json``, as 15b): tracked >= JAX - 2, the track-time
   poses' RMSE <= 2 x JAX + 2 mm, keyframes +-1.  Both: K1-K3 once per
   extraction dispatch (a batch, or the initialisation frame), K4 and K1's
   dense form never, one copy back per tracking dispatch; frames/s, batch
   latency (first, p50, max) and host ms a tracking dispatch beside 12a's
   and 15b's frame-by-frame figures of the same run
   (``scripts/torch_port_profile_lap.py --mode batch_modes`` profiles one
   dispatch against the same frames frame by frame);

after each of the laps 4, 5, 7, 8, 9, 10a, 11a, 12a, 12b, 13a-c, 14a-c, 15a-c and 17a-b, every kernel against its plain
version on the inputs the lap gave it, one input for each distinct shape
(``KernelInputs``: the mono lap's batches of 16 and its last of 8 frames,
the stereo batch lap's 2, 32 and 30 images, its 16 and 15 pairs), to the
same limits; then one JSON line of per-kernel results (all five wrappers, their
launches in every lap), the ``nvidia-smi`` line again, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with 1
before any of this.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "rgbd_localization_lap.json")
STEREO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "stereo_slam_lap.json")
MONO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "mono_slam_lap.json")
STEREO_BATCH_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "stereo_batch_lap.json")
RELOC_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "mono_reloc_lap.json")
LOOP_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "mono_loop_lap.json")
CORRECTION_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "loop_correction_full.json")
SI_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "stereo_inertial_lap.json")
FOURDOF_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "loop_4dof_full.json")
FE_STEREO_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "fisheye_stereo_lap.json")
FE_INERTIAL_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "fisheye_inertial_lap.json")
ATLAS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "atlas_lap.json")
STEREO_ATLAS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "stereo_atlas_lap.json")
INERTIAL_ATLAS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "inertial_atlas_lap.json")

W, H = 752, 480
CAM_PARAMS = (458.654, 457.296, 367.215, 248.375)
BASELINE = 0.11
N_FRAMES = 48

K2_ATOL = 1e-4          # blur kernel vs plain; both round every tap the same way
# SAD kernel vs plain: 121 float32 terms summed in another order, on sums
# of order 1e3-1e4 (one float32 ulp there is ~1e-3)
K4_ATOL = 1e-2
K4_ARGMIN_SHARE = 0.999  # keypoints whose best of the 11 shifts is the same
POS_TOL_M = 0.005       # per-frame camera centre vs the JAX run
TRACKED_MARGIN = 2      # frames below the JAX run's tracked count
RMSE_FACTOR, RMSE_SLACK_M = 2.0, 0.002  # rmse <= 2 x JAX rmse + 2 mm
KF_MARGIN, KF_MIN = 1, 3  # stereo lap: keyframes within +-1 of the JAX run's, at least 3
INIT_MAP_RTOL = 0.01      # stereo lap: frame 0's map size vs the JAX run's
BATCH = 16                # frames per process_batch dispatch (bench.py)
MONO_FRAMES = 120
# mono lap against the JAX run: initialised no later than 4 frames after it,
# tracked >= JAX - 3, Sim(3)-aligned ATE <= 2 x JAX + 2 mm, keyframes +-2
MONO_INIT_MARGIN, MONO_TRACKED_MARGIN, MONO_KF_MARGIN = 4, 3, 2
# kidnapped lap against the JAX run: each relocalisation at most one frame
# after the JAX run's, to the same candidate keyframe, with at least half
# its PnP inliers: the best of 128 six-point DLTs swings with how many sets
# span two walls of the room (the port drew 206 against JAX's 311 on the
# CPU, scripts/torch_port_reloc_probe.py, and 421 on an H100),
# and the JAX package's DLT loses about half its hypotheses to the SVD's
# null-vector sign, the port's none (tests/test_torch_pnp.py); as many
# relocalisations; tracked, ATE and keyframes as the mono lap (ATE over
# every frame that is not blank)
RELOC_FRAMES = 79
RELOC_FRAME_MARGIN, RELOC_PNP_SHARE = 1, 0.5
# bench.py's 400-frame loop lap against the JAX run, in each arm: initialised
# no later than 4 frames after it, tracked >= JAX - 8, ATE <= 2 x JAX + 2 mm
# (as the mono lap), keyframe insertions within +-4
LOOP_FRAMES = 400
LOOP_INIT_MARGIN, LOOP_TRACKED_MARGIN, LOOP_KF_MARGIN = 4, 8, 4
# loops: as many as the JAX run closed, and each loop the port closes is one
# the JAX run's own ladder put forward: a Sim(3) refinement of the JAX run
# that kept the acceptance gate's 20 inliers for a pair of keyframes within
# 16 frames of the port's on both ends, whose rotation is within 1 degree of
# the port's loop.  Where the JAX run accepted a loop, the port's returns to
# the same place (the candidate keyframe within 16 frames).  On the wide arm
# the JAX run's ladder refines the return to keyframe 2 (frame 5) at frame
# 134, 7.3 degrees off the true relative rotation, and turns it down on
# RANSAC's 16 inliers (the gate is 25) before it accepts (166, 7); the
# port's map gives that RANSAC 41 and the port accepts it at frame 133,
# 0.4 degrees from the JAX run's refinement (PERF.md section 2).  Each
# loop's distance from the truth is reported, not held: the JAX package
# accepts loops up to 9 degrees off it on this lap with other draws
LOOP_FRAME_MARGIN, LOOP_SIM3_DEG = 16, 1.0
SIM3_MIN_INLIERS = 20  # LoopCloser.sim3_min_inliers
# the full-width loop correction against the JAX run: the loop (63, 0), its
# scale within 1e-3 of the JAX run's, the median corrected point within
# 1e-3 m of the truth, keyframe poses within 1e-3 (m) of the JAX run's
CORR_S_TOL, CORR_POINT_M, CORR_POSE_TOL = 1e-3, 1e-3, 1e-3
CORR_RUNS = 3  # corrections timed: the first apart from the rest
# bench.py's stereo-inertial lap against the JAX run: tracked >= JAX - 3, the
# final imu_stage equal, each stage reached within one batch of the JAX
# run's, SE(3)-aligned ATE <= 2 x JAX + 2 mm and the Sim(3) scale within
# 0.05 of the JAX run's, the first IMU init's gravity within 1 degree of
# the JAX run's, keyframe insertions +-4, loops closed equal
SI_FRAMES = 240
SI_TRACKED_MARGIN, SI_STAGE_FRAMES, SI_KF_MARGIN = 3, BATCH, 4
SI_SCALE_TOL, SI_GRAVITY_DEG = 0.05, 1.0
# one 4-DoF loop correction at full width against the JAX run: poses within
# 1e-4 (m, and rotation entries), every keyframe's roll and pitch unchanged
# to 1e-5 rad
FOURDOF_TOL, FOURDOF_TILT = 1e-4, 1e-5
FOURDOF_RUNS = 3
# the TUM-VI fisheye laps (512x512, 100 pairs) against the JAX run: tracked
# >= JAX - 2; FisheyeStereoSLAM: ATE with the first pose's offset removed <=
# 2 x JAX + 2 mm, keyframes +-2, the initial map and frame 0's fisheye stereo
# matches within 1% of the JAX run's; FisheyeStereoInertialSLAM: the final
# imu_stage equal, each stage reached within one frame of the JAX run's, the
# first IMU init's gravity within 1 degree, SE(3)-aligned ATE <= 2 x JAX + 2
# mm, keyframe insertions +-4, and its first 16 frames through process_batch
# the same records as through process
FE_FRAMES, FE_W, FE_H = 100, 512, 512
FE_TRACKED_MARGIN, FE_KF_MARGIN, FE_RTOL = 2, 2, 0.01
FE_STAGE_FRAMES, FE_GRAVITY_DEG, FE_VI_KF_MARGIN = 1, 1.0, 4
FE_BATCH_FRAMES = 16
# the window of the profiled run (launches a frame by stage): frames 10-13,
# tracking only (the JAX run inserts its keyframes at frames 1 and 66 or so)
FE_PROFILE_FRAMES = (10, 14)
# phase 17, the batch modes of RGB-D and fisheye stereo at B = BATCH: 17a
# over phase 12's pairs (cut to the first 64, as 14c, only if the whole run
# nears the time limit), its second-camera rows >= FE_XYR_SHARE of 12a's;
# 17b over phase 4's frames, held as 15b; the facade calls counted
FE_BATCH_LAP_FRAMES = 100
FE_XYR_SHARE = 0.9
BATCH_LAP_CALLS = ("_batch_track", "_batch_retrack", "_host_copy", "process")

# the Atlas laps (phase 13) against the JAX runs: maps created and merges
# equal; the merge within ATLAS_MERGE_FRAMES frames of JAX's, from the same
# candidate keyframe or one whose frame is within ATLAS_CAND_FRAMES of it
# (the stored map's culls can keep a neighbouring keyframe instead:
# tests/test_torch_atlas.py measures one such swap on the CPU), its RANSAC
# inliers at least half JAX's; merged keyframes +-2, tracked >= JAX - 3
# (mono; -2 after the merge on the inertial lap), ATE <= 2 x JAX + 2 mm
# (Sim(3) mono, SE(3) stereo and inertial); the inertial weld of two metric
# maps at scale 1 with roll and pitch under ATLAS_TILT_RAD and yaw within
# ATLAS_YAW_DEG of the yaw of JAX's world transform before its projection
# (the JAX package projects the wrong rotation: ROADMAP Queue 3; the
# candidate there follows a vocabulary trained on map A, and on the CPU the
# port merged from another keyframe, 0.73 degrees and 25 cm from JAX's
# transform, 48 inliers against 37).  The world transform of the stereo
# merge within ATLAS_METRIC_DEG and ATLAS_METRIC_T_M of JAX's and at JAX's
# scale (measured: 0.023 degrees, 2.7 mm on the CPU; 0 degrees, 1.6 mm on an
# NVIDIA H100 80GB HBM3, 700.00 W); a monocular merge joins a map of two keyframes a few frames
# apart, whose Sim(3) the RANSAC's 5%-of-depth gate leaves loose: on the
# mono lap the JAX run's rotation is 13.2 degrees from the true one, the
# port's on the same draws 10.9 degrees on an NVIDIA H100 80GB HBM3,
# 700.00 W (4.9 degrees and 7.2% in scale from JAX's) and 16.7 on a CPU
# (3.5 degrees, 5.2%), so there its distance from the true rotation is held
# as the ATE is, to at most ATLAS_MONO_DEG_FACTOR times JAX's plus
# ATLAS_MONO_DEG, and its scale to within ATLAS_MONO_SCALE of JAX's
ATLAS_MERGE_FRAMES, ATLAS_CAND_FRAMES = 2, 3
ATLAS_METRIC_DEG, ATLAS_METRIC_T_M = 0.1, 5e-3
ATLAS_MONO_DEG_FACTOR, ATLAS_MONO_DEG, ATLAS_MONO_SCALE = 2.0, 2.0, 0.15
ATLAS_TILT_RAD, ATLAS_YAW_DEG, ATLAS_KF_MARGIN = 1e-6, 2.0, 2
# 13d: the checkpoint taken right after the merge, restored into a fresh
# MonoSLAM; the next frames in the restored and the original system
ATLAS_CKPT_FRAMES = 16
# phase 15, the live node against the JAX node's runs: tracked >= JAX - 2,
# accuracy <= 2 x JAX + 2 mm (RMSE_FACTOR, RMSE_SLACK_M), keyframes within
# +-2 (stereo-inertial) and +-1 (RGB-D), imu_stage equal, the overlay's
# matched keypoints on the last frame >= 90% of JAX's; the viewer is read
# after these frames; frames go out at camera rate in 15c
NODE_SI_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "node_stereo_inertial.json")
NODE_RGBD_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "node_rgbd.json")
NODE_SI_FRAMES = 80
NODE_TRACKED_MARGIN, NODE_SI_KF_MARGIN, NODE_RGBD_KF_MARGIN = 2, 2, 1
NODE_MATCHED_SHARE = 0.9
NODE_VIEW_FRAMES = (24, 48)
NODE_CAMERA_FPS = 20.0
NODE_RECV_TIMEOUT_S = 300  # a frame's POSE (the first builds nothing: phase 2 built the kernels)
# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores (every kernel here is float32 or integer arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

KERNEL_SOURCES = {
    "fast_candidates": ("orb_slam3_noted_tpu_torch/csrc/fast_score.cu",
                        "orb_slam3_noted_tpu/ops/pallas_kernels.py:55"),
    "gaussian_blur7": ("orb_slam3_noted_tpu_torch/csrc/gaussian_blur7.cu",
                       "orb_slam3_noted_tpu/ops/pallas_kernels.py:189"),
    "brief_sample": ("orb_slam3_noted_tpu_torch/csrc/brief_sample.cu",
                     "orb_slam3_noted_tpu/ops/pallas_kernels.py:292"),
    "sad_stereo": ("orb_slam3_noted_tpu_torch/csrc/sad_stereo.cu",
                   "orb_slam3_noted_tpu/ops/pallas_kernels.py:448"),
    # K1's single-level form: the dense score map, off every lap's path
    "fast_score": ("orb_slam3_noted_tpu_torch/csrc/fast_score.cu",
                   "orb_slam3_noted_tpu/ops/pallas_kernels.py:55"),
}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the float32 rate, and which of the two."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median of per-call times (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# The matches whose device time came from ``event_device_time_ms`` because
# the profiler recorded none of their kernels (printed at the end of a run).
EVENT_TIMED: list = []


def device_time_ms(fn, match: str | None = None, reps: int = 10) -> float:
    """Device time of one call of ``fn``: the durations of the kernels it
    launches, as ``torch.profiler`` records them on the card.  Without
    ``match``: all of them, summed over ``reps`` calls and divided by
    ``reps``.  With ``match``: only the kernels whose name contains it (a
    hand-written kernel's own body, launched once per call), as the mean of
    the launches the profiler recorded.  The profiler misses some of a
    session's records now and then, and a session that recorded none is
    profiled again; after three such sessions the call is timed by
    ``event_device_time_ms`` instead, and ``match`` goes into
    ``EVENT_TIMED``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA
                and (match is None or match in k.key)]
        if rows:
            n = reps if match is None else sum(k.count for k in rows)
            return sum(k.self_device_time_total for k in rows) / 1e3 / n
    t = event_device_time_ms(fn, reps)
    EVENT_TIMED.append(match)
    print(f"[timing] the profiler recorded no device kernel matching {match!r} in 3 sessions; "
          f"CUDA events behind a spin kernel give {t:.5f} ms a call", file=sys.stderr, flush=True)
    return t


def event_device_time_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn`` without the profiler: a spin kernel
    keeps the card busy while the host enqueues ``reps`` calls, and CUDA
    events recorded after the spin and after the last call bracket the
    device's work alone (every kernel the calls launch and the gaps between
    them), divided by ``reps``.  The spin lasts twice the host's enqueue
    time of the calls; a call that waits for the card inside is timed with
    that wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second on an H100
    torch.cuda._sleep(int(max(2 * enqueue_s, 1e-3) * 2e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_time_ms(fn, reps: int = 100) -> float:
    """Host time of one call of ``fn``: the host clock over ``reps`` calls
    that only enqueue (no synchronise inside the loop), divided by ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def lap_config():
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE

    cam = Camera(PINHOLE, CAM_PARAMS)
    return SlamConfig(
        camera=cam, width=W, height=H, n_features=1200, n_levels=8,
        scale_factor=1.2, bf=BASELINE * cam.fx, th_depth=45.0,
        max_keyframes=64, max_map_points=16384,
        local_window=5, kf_max_interval=10, enable_loop_closing=False,
    )


def mono_config(loop_closing: bool = False):
    """``bench.py``'s monocular configuration (which runs with loop closing
    on), loop closing as asked."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE

    return SlamConfig(
        camera=Camera(PINHOLE, CAM_PARAMS), width=W, height=H, n_features=1200,
        max_keyframes=64, max_map_points=8192, local_window=5, kf_max_interval=10,
        enable_loop_closing=loop_closing,
    )


def stored_poses(path: str, n_frames: int) -> list:
    """The ``n_frames`` poses of ``orbit_trajectory(n_frames, forward=0.03,
    yaw0=0.45)`` with the camera rotations the JAX run's frames were rendered
    from (``rwc_f32`` of the fixture at ``path``): the port's trajectory
    rounds a few of them 1 ulp away from the JAX package's ``so3.exp``, which
    moves edge pixels of a render."""
    import base64

    from orb_slam3_noted_tpu_torch.utils.synthetic import orbit_trajectory

    ref = load_fixture(path, n_frames)
    rwc = np.frombuffer(base64.b64decode(ref["rwc_f32"]), "<f4").reshape(n_frames, 3, 3)
    ours = orbit_trajectory(n_frames, forward=0.03, yaw0=0.45)
    if max(float(np.abs(R - Rf).max()) for (R, _), Rf in zip(ours, rwc)) > 1e-6:
        raise AssertionError(f"{path}: the rotations are not this lap's")
    return [(Rf.copy(), t) for (_, t), Rf in zip(ours, rwc)]


_ROOM = []


def _render_job(job):
    """One frame of a lap in ``BoxRoom(seed=0)``: ("mono", Rwc, twc) -> the
    uint8 image, ("stereo", Rwc, twc) -> (left uint8, right uint8, left depth
    float32); ("mono_seed3", Rwc, twc) the image in ``BoxRoom(seed=3)``."""
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, stereo_pair

    if not _ROOM:
        _ROOM.extend([BoxRoom(seed=0), BoxRoom(seed=3)])
    kind, R, t = job
    if kind == "stereo":
        left, right, depth = stereo_pair(_ROOM[0], R, t, CAM_PARAMS, W, H, BASELINE)
        return left.astype(np.uint8), right.astype(np.uint8), depth.astype(np.float32)
    room = _ROOM[1] if kind == "mono_seed3" else _ROOM[0]
    return room.render(R, t, CAM_PARAMS, W, H).astype(np.uint8)


_POOL = []


def pool_map(fn, jobs: list) -> list:
    """``fn`` over ``jobs`` on one pool of up to 8 spawned worker processes,
    started at the first call and kept for the rest of the run (each worker
    imports torch once and keeps its rooms); ``close_pool`` ends it."""
    if not _POOL:
        import multiprocessing

        _POOL.append(multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1)))
    return _POOL[0].map(fn, jobs, chunksize=4)


def close_pool() -> None:
    while _POOL:
        pool = _POOL.pop()
        pool.close()
        pool.join()


def render(jobs: list) -> list:
    """The frames of ``jobs`` (see ``_render_job``), rendered by the worker
    pool: the renderer is numpy on the CPU, ~0.2 s a 752x480 image, and the
    laps render ~1,400."""
    return pool_map(_render_job, jobs)


def mono_inputs():
    """(poses, (n, H, W) uint8 images) of ``bench.py``'s monocular lap,
    rendered from the JAX run's camera rotations."""
    poses = stored_poses(MONO_FIXTURE, MONO_FRAMES)
    return poses, np.stack(render([("mono", R, t) for R, t in poses]))


def lap_inputs(n_frames: int):
    """(poses, [(left uint8, right uint8, left depth float32)]): the RGB-D
    lap takes left and depth, the stereo lap left and right; rendered from
    the JAX run's camera rotations, which the three fixtures store alike."""
    poses = stored_poses(FIXTURE, n_frames)
    for path in (STEREO_FIXTURE, STEREO_BATCH_FIXTURE):
        if any(not np.array_equal(R, Rf) for (R, _), (Rf, _) in
               zip(poses, stored_poses(path, n_frames))):
            raise AssertionError(f"{path}: other rotations than {FIXTURE}'s")
    return poses, render([("stereo", R, t) for R, t in poses])


def kernel_times(fn, name: str) -> dict:
    """Times of one wrapper call in ms: ``ms`` the kernel's own duration on
    the device, ``per_call_ms`` CUDA events around one call (the wrapper's
    host path with the device waiting), ``host_ms`` the enqueue alone."""
    return {"ms": device_time_ms(fn, name + "_kernel"), "per_call_ms": cuda_time_ms(fn),
            "host_ms": host_time_ms(fn)}


def reference_times(fn, prefix: str) -> dict:
    """Device time (all the kernels the call launches) and per-call time of
    a plain version or a library call."""
    return {f"{prefix}_ms": device_time_ms(fn), f"{prefix}_per_call_ms": cuda_time_ms(fn)}


def extraction_args(cfg) -> dict:
    return dict(n_features=cfg.n_features, n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
                th_high=cfg.ini_th_fast, th_low=cfg.min_th_fast)


def pair_atlas(cfg, left_u8, right_u8, dev):
    """(pyramid, atlas) of the stacked pair, as the stereo facade builds them."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import image as image_ops

    im = torch.as_tensor(np.stack([left_u8, right_u8]), dtype=torch.float32).to(dev)
    pyr = tuple(image_ops.build_pyramid(im, cfg.n_levels, cfg.scale_factor))
    return pyr, image_ops.build_atlas(pyr)


def compass_pass_count(levels, th_low: float, border: int) -> int:
    """Pixels of the scored area (the kept area and one pixel around it) of
    these levels whose FAST score can exceed ``th_low``: two neighbouring
    compass points of the ring both brighter than the centre by more than
    ``th_low``, or both darker.  K1 takes the full score of these alone."""
    import torch

    n = 0
    for lv in levels:
        h, w = lv.shape
        d = [torch.roll(lv, (-dy, -dx), (0, 1)) - lv for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
        ok = torch.zeros_like(lv, dtype=torch.bool)
        for side in ([x > th_low for x in d], [x < -th_low for x in d]):
            for a in range(4):
                ok |= side[a] & side[(a + 1) % 4]
        n += int(ok[border - 1:h - border + 1, border - 1:w - border + 1].sum())
    return n


def check_launch_floor(dev) -> float:
    """Device time of the empty kernel, timed as every kernel here is."""
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    return device_time_ms(lambda: ck.launch_floor(dev), "launch_floor_kernel")


def check_kernels(cfg, left_u8, right_u8, dev) -> dict:
    """K1-K3 against their plain versions at the lap's shapes, each one
    launch over the pyramid atlas: the main numbers are for one image
    (B = 1, the RGB-D lap's shape), the ``*_pair`` ones for the stacked
    stereo pair (B = 2); the single-level forms are checked too."""
    import torch
    import torch.nn.functional as F

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
    from orb_slam3_noted_tpu_torch.ops import image as image_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O

    kw = extraction_args(cfg)
    pyr, pair = pair_atlas(cfg, left_u8, right_u8, dev)
    one = pair._replace(image=pair.image[0])
    pyrs = [tuple(lv[b].contiguous() for lv in pyr) for b in range(2)]
    det_pair = O.detect_from_atlas(pair, **kw)
    dets = [O.Detections(*(f[b] for f in det_pair)) for b in range(2)]
    sizes = one.sizes
    px = sum(h * w for h, w in sizes)
    K = dets[0].xy.shape[0]
    log(f"  atlas {tuple(one.image.shape)}, levels {sizes}, {K} keypoints an image")
    res = {}

    # --- K1 over the atlas, and its dense single-level form --------------------
    budgets = tuple(fast_ops.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor))
    th, border = (cfg.ini_th_fast, cfg.min_th_fast), 16
    lay = ck.candidate_layout(sizes, budgets)

    c1, c2 = (compare_fast(a.image, sizes, budgets, *th, border) for a in (one, pair))
    dense = [(ck.fast_score(lv), ck.fast_score_plain(lv)) for lv in pyrs[0]]
    mism1 = sum(int((a != b).sum()) for a, b in dense)
    log(f"  fast_candidates: {lay.n_cells} cells x {lay.k_max} slots (k per level {lay.k}); B=1 "
        f"{c1['mismatches']} of {c1['of']} candidates differ, B=2 {c2['mismatches']} of "
        f"{c2['of']}; dense score map, 8 levels: {mism1} of {px} pixels differ")

    def replaced():  # the per-level route this launch replaces: K1 dense + selection's first half
        return [fast_ops.cell_candidates(ck.fast_score(lv), n, ck.CELL, *th, border)
                for lv, n in zip(pyrs[0], budgets)]

    scored = sum((h - 2 * border + 2) * (w - 2 * border + 2) for h, w in sizes)
    n_full = compass_pass_count(pyrs[0], th[1], border)
    log(f"  fast_candidates: {n_full} of {scored} scored pixels pass the compass test and get "
        f"the full score")
    r = {"max_abs_err": max(c1["max_abs_err"], c2["max_abs_err"]),
         "mismatches": c1["mismatches"] + c2["mismatches"] + mism1,
         **kernel_times(lambda: ck.fast_candidates(one.image, sizes, budgets, *th, border),
                        "fast_candidates"),
         **reference_times(
             lambda: ck.fast_candidates_plain(one.image, sizes, budgets, *th, border), "plain"),
         **reference_times(replaced, "replaced"),
         "dense_ms": sum(device_time_ms(lambda: ck.fast_score(lv), "fast_score_kernel")
                         for lv in pyrs[0]),
         "library_ms": None,
         # every level pixel read once, scores and indices written; per scored
         # pixel (the kept area and one pixel around it) the compass test (4
         # differences, 8 comparisons, 15 logical operations) and the peak
         # test's 8 maxima and 3 comparisons; per pixel of this frame that
         # passes the compass test the other 12 ring differences, 4 x 16
         # minima and as many maxima, 2 x 15 + 1 to reduce them
         "bytes": 4 * px + 8 * lay.n_cells * lay.k_max,
         "ops": (27 + 11) * scored + (12 + 128 + 31) * n_full}
    r.update({k + "_pair": v for k, v in kernel_times(
        lambda: ck.fast_candidates(pair.image, sizes, budgets, *th, border),
        "fast_candidates").items()})
    res["fast_candidates"] = r

    # --- K2 over the atlas ---------------------------------------------------
    taps = torch.from_numpy(image_ops.gaussian_kernel1d(7, ck.BLUR_SIGMA)).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardstick computes in float32 too

    def blur_library(x):
        y = F.pad(x[None, None], (3, 3, 3, 3), mode="reflect")
        return F.conv2d(F.conv2d(y, taps.view(1, 1, 1, 7)), taps.view(1, 1, 7, 1))[0, 0]

    def blur_library_all():
        return [blur_library(lv) for lv in pyrs[0]]

    plain_one = ck.gaussian_blur7_plain(one.image, sizes)
    for lib, ref in zip(blur_library_all(), image_ops.level_views(plain_one, sizes)):
        if float((lib - ref).abs().max()) > 1e-3:
            raise AssertionError("the library blur computes another function")
    lv0 = pyrs[0][0]
    cs_ = [compare_blur(one.image, sizes), compare_blur(pair.image, sizes), compare_blur(lv0)]
    log(f"  gaussian_blur7: atlas B=1 max_abs_err {cs_[0]['max_abs_err']:.3g} "
        f"({cs_[0]['mismatches']} differ), B=2 {cs_[1]['max_abs_err']:.3g} "
        f"({cs_[1]['mismatches']} differ), single level {tuple(lv0.shape)} "
        f"{cs_[2]['max_abs_err']:.3g}")
    r = {"max_abs_err": max(c["max_abs_err"] for c in cs_),
         "mismatches": sum(c["mismatches"] for c in cs_),
         **kernel_times(lambda: ck.gaussian_blur7(one.image, sizes), "gaussian_blur7"),
         **reference_times(lambda: ck.gaussian_blur7_plain(one.image, sizes), "plain"),
         **reference_times(blur_library_all, "library"),
         # read + write one float per level pixel; two passes of 7 multiplies and 6 adds
         "bytes": 8 * px, "ops": 26 * px}
    r.update({k + "_pair": v for k, v in
              kernel_times(lambda: ck.gaussian_blur7(pair.image, sizes), "gaussian_blur7").items()})
    torch.backends.cudnn.allow_tf32 = tf32
    res["gaussian_blur7"] = r

    # --- K3 over the blurred atlas ------------------------------------------
    def brief_args(atlas, det):
        blur = ck.gaussian_blur7_plain(atlas.image, sizes)
        return blur, sizes, det.xy.to(torch.int32), det.angle, det.level

    args_one, args_pair = brief_args(one, dets[0]), brief_args(pair, det_pair)
    c1, c2 = compare_brief(*args_one), compare_brief(*args_pair)
    # the single-level form on level 0: its keypoints are the first ones
    k0 = int((dets[0].level == 0).sum())
    blur0 = ck.gaussian_blur7(lv0)
    d0 = O.brief_descriptors(blur0, dets[0].xy[:k0], dets[0].angle[:k0])
    gy, gx = O.brief_coords(lv0.shape[0], lv0.shape[1], dets[0].xy[:k0], dets[0].angle[:k0])
    mism1 = int((d0 != ck.brief_sample_plain(blur0, gy, gx)).any(dim=-1).sum())
    log(f"  brief_sample: atlas B=1 {c1['mismatches']} of {K} descriptors differ, B=2 "
        f"{c2['mismatches']} of {2 * K}, single level {mism1} of {k0}")
    r = {"max_abs_err": max(c1["max_abs_err"], c2["max_abs_err"]),
         "mismatches": c1["mismatches"] + c2["mismatches"] + mism1,
         **kernel_times(lambda: ck.brief_sample(*args_one), "brief_sample"),
         **reference_times(lambda: ck.brief_sample_atlas_plain(*args_one), "plain"),
         "library_ms": None,
         # per keypoint: the 512 samples read, its coordinates, angle and
         # level read, 8 words written; 512 rotations (4 multiplies, 2 sums,
         # 2 roundings each) and 256 comparisons
         "bytes": K * (512 * 4 + 16 + 32), "ops": K * (512 * 8 + 256)}
    r.update({k + "_pair": v for k, v in
              kernel_times(lambda: ck.brief_sample(*args_pair), "brief_sample").items()})
    res["brief_sample"] = r

    torch.cuda.synchronize()
    if res["fast_candidates"]["mismatches"] or res["brief_sample"]["mismatches"]:
        raise AssertionError("K1/K3 must match their plain versions exactly")
    if res["gaussian_blur7"]["max_abs_err"] > K2_ATOL:
        raise AssertionError(f"K2 differs from its plain version by more than {K2_ATOL}")
    return res


def check_sad(cfg, left_u8, right_u8, dev) -> dict:
    """K4 against its plain version at the stereo lap's shapes: frame 0's
    two pyramids as atlases, its 1200 left keypoints and the right
    candidates the Hamming gate gives them."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import orb as O
    from orb_slam3_noted_tpu_torch.ops import stereo as S

    pyr, pair = pair_atlas(cfg, left_u8, right_u8, dev)
    both = O.extract_from_atlas(pair, **extraction_args(cfg))
    feats = [O.FrameFeatures(*(f[b] for f in both)) for b in range(2)]
    idx_r, have = S.hamming_candidates(feats[0], feats[1], cfg.bf, BASELINE,
                                       cfg.n_levels, cfg.scale_factor)
    cv, cu, cur, _ = S.level_centres(feats[0], feats[1], idx_r, tuple(p[0] for p in pyr))
    al, ar = (pair._replace(image=pair.image[b]) for b in range(2))
    args = (al.image, ar.image, cv, cu, cur, feats[0].level.contiguous(), al.off, al.h, al.w)
    K = cv.shape[0]
    use = have & feats[0].valid  # the rows whose SADs the matcher reads
    # the same centres on atlases of uniform noise: no two neighbouring
    # pixels alike, so every one of the 121 terms is a float of its own
    g = torch.Generator(device=dev).manual_seed(0)
    noise = [torch.rand(al.image.shape, generator=g, device=dev) * 255.0 for _ in range(2)]
    c_lap, c_noise = compare_sad(*args, use=use), compare_sad(*noise, *args[2:])
    log(f"  sad_stereo: atlas {tuple(al.image.shape)}, K={K}, candidates {c_lap['of']}; lap "
        f"inputs max_abs_err {c_lap['max_abs_err']:.3g}, same best shift {c_lap['same']:.5f}; "
        f"noise atlases max_abs_err {c_noise['max_abs_err']:.3g}, same best shift "
        f"{c_noise['same']:.5f}")
    hold_to_limits("sad_stereo", c_lap, "lap frame 0")
    hold_to_limits("sad_stereo", c_noise, "noise atlases")
    # per keypoint: 121 + 231 gathered floats, 3 centres and a level read,
    # 11 sums written; 11 shifts x 121 x (subtract, abs, add)
    return {
        "max_abs_err": max(c_lap["max_abs_err"], c_noise["max_abs_err"]),
        "mismatches": c_lap["mismatches"],
        **kernel_times(lambda: ck.sad_stereo(*args), "sad_stereo"),
        **reference_times(lambda: ck.sad_stereo_plain(*args), "plain"),
        "bytes": K * ((121 + 231) * 4 + 4 * 4 + 11 * 4), "ops": K * 11 * 121 * 3,
        "library_ms": None,
    }


def compare_fast(image, sizes, budgets, th_high, th_low, border) -> dict:
    """K1 against its plain version on one input: every candidate slot's
    score, and the index of every filled slot."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import fast as fast_ops

    (s, i), (ps, pi) = (ck.fast_candidates(image, sizes, budgets, th_high, th_low, border),
                        ck.fast_candidates_plain(image, sizes, budgets, th_high, th_low, border))
    torch.cuda.synchronize()
    filled = ps > fast_ops.NEG / 2
    return {"max_abs_err": float((s - ps).abs().max()),
            "mismatches": int((s != ps).sum()) + int(((i != pi) & filled).sum()),
            "of": int(filled.sum())}


def compare_blur(img, sizes=None) -> dict:
    """K2 against its plain version over the level windows (the padding is
    unwritten on the card)."""
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import image as image_ops

    win = sizes or (tuple(img.shape[-2:]),)
    pairs = list(zip(image_ops.level_views(ck.gaussian_blur7(img, sizes), win),
                     image_ops.level_views(ck.gaussian_blur7_plain(img, sizes), win)))
    return {"max_abs_err": max(float((a - b).abs().max()) for a, b in pairs),
            "mismatches": sum(int((a != b).sum()) for a, b in pairs),
            "of": sum(a.numel() for a, _ in pairs)}


def compare_brief(*args) -> dict:
    """K3 against its plain version: descriptors that differ in any bit."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    out = ck.brief_sample(*args)
    torch.cuda.synchronize()
    mism = int((out != ck.brief_sample_atlas_plain(*args)).any(dim=-1).sum())
    return {"max_abs_err": float(mism > 0), "mismatches": mism, "of": out[..., 0].numel()}


def compare_sad(*args, use=None) -> dict:
    """K4 against its plain version: the largest difference of a sum, and
    the rows (those in ``use``, else all) whose best of the 11 shifts moved."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    sads = ck.sad_stereo(*args)
    torch.cuda.synchronize()
    plain = ck.sad_stereo_plain(*args)
    moved = sads.argmin(-1) != plain.argmin(-1)
    use = torch.ones_like(moved) if use is None else use
    n = int(use.sum())
    mism = int((moved & use).sum())
    return {"max_abs_err": float((sads - plain).abs().max()), "mismatches": mism, "of": n,
            "same": 1.0 - mism / max(n, 1)}


COMPARE = {"fast_candidates": compare_fast, "gaussian_blur7": compare_blur,
           "brief_sample": compare_brief, "sad_stereo": compare_sad}


def hold_to_limits(name: str, r: dict, where: str) -> None:
    """The limits of every kernel-against-plain check: K1 and K3 exact, K2
    within ``K2_ATOL``, K4 within ``K4_ATOL`` with the same best shift on
    ``K4_ARGMIN_SHARE`` of the rows."""
    if name in ("fast_candidates", "brief_sample") and r["mismatches"]:
        raise AssertionError(f"{name} ({where}): {r['mismatches']} of {r['of']} differ from "
                             f"its plain version")
    if name == "gaussian_blur7" and r["max_abs_err"] > K2_ATOL:
        raise AssertionError(f"{name} ({where}): max_abs_err {r['max_abs_err']} > {K2_ATOL}")
    if name == "sad_stereo" and (r["max_abs_err"] > K4_ATOL or r["same"] < K4_ARGMIN_SHARE):
        raise AssertionError(f"{name} ({where}): max_abs_err {r['max_abs_err']}, same best "
                             f"shift {r['same']:.5f}")


def check_extraction_batch(cfg, pyr, atlas, tag: str) -> dict:
    """K1, K2 and K3 over one (B, HA, W0) atlas against their plain versions,
    each timed three ways beside its bound; keys end in ``_<tag>``."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import fast as fast_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O

    B = atlas.image.shape[0]
    sizes = atlas.sizes
    px = sum(h * w for h, w in sizes)
    budgets = tuple(fast_ops.level_budgets(cfg.n_features, cfg.n_levels, cfg.scale_factor))
    th, border = (cfg.ini_th_fast, cfg.min_th_fast), 16
    lay = ck.candidate_layout(sizes, budgets)
    blurred = ck.gaussian_blur7_plain(atlas.image, sizes)
    det = O.detect_from_atlas(atlas, **extraction_args(cfg))
    K = det.xy.shape[-2]
    brief_args = (blurred, sizes, det.xy.to(torch.int32), det.angle, det.level)
    scored = sum((h - 2 * border + 2) * (w - 2 * border + 2) for h, w in sizes)
    n_full = sum(compass_pass_count([lv[b] for lv in pyr], th[1], border) for b in range(B))
    cases = {
        "fast_candidates": (
            (atlas.image, sizes, budgets, *th, border),
            lambda: ck.fast_candidates(atlas.image, sizes, budgets, *th, border),
            lambda: ck.fast_candidates_plain(atlas.image, sizes, budgets, *th, border),
            B * (4 * px + 8 * lay.n_cells * lay.k_max),
            B * (27 + 11) * scored + (12 + 128 + 31) * n_full),
        "gaussian_blur7": (
            (atlas.image, sizes), lambda: ck.gaussian_blur7(atlas.image, sizes),
            lambda: ck.gaussian_blur7_plain(atlas.image, sizes), B * 8 * px, B * 26 * px),
        "brief_sample": (
            brief_args, lambda: ck.brief_sample(*brief_args),
            lambda: ck.brief_sample_atlas_plain(*brief_args),
            B * K * (512 * 4 + 16 + 32), B * K * (512 * 8 + 256)),
    }
    res = {}
    for name, (args, fn, plain, n_bytes, n_ops) in cases.items():
        c = COMPARE[name](*args)
        hold_to_limits(name, c, f"B={B}")
        log(f"  {name} B={B}: {c['mismatches']} of {c['of']} differ, max_abs_err "
            f"{c['max_abs_err']:.3g}" + (f"; {n_full} of {B * scored} scored pixels pass the "
                                         f"compass test" if name == "fast_candidates" else ""))
        r = {"max_abs_err": c["max_abs_err"], "mismatches": c["mismatches"],
             **kernel_times(fn, name), **reference_times(plain, "plain")}
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, n_ops)
        res[name] = {f"{k}_{tag}": v for k, v in r.items()}
    return res


def check_batch_kernels(cfg, imgs, lefts, rights, dev) -> dict:
    """K1, K2 and K3 over the (16, HA, W0) atlas of 16 images (a mono batch
    dispatch, keys ``_b16``) and over the (32, HA, W0) atlas of 16 stereo
    pairs (a stereo batch dispatch, ``_b32``), and K4 over those 16 pairs
    (``_b16``), against their plain versions to the limits of the B = 1
    checks; each timed three ways beside its bound.  Returns {name: {key:
    value}}."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import image as image_ops
    from orb_slam3_noted_tpu_torch.ops import orb as O
    from orb_slam3_noted_tpu_torch.ops import stereo as S

    def pyramid_atlas(images):
        batch = torch.as_tensor(np.stack(images), dtype=torch.float32).to(dev)
        pyr = tuple(image_ops.build_pyramid(batch, cfg.n_levels, cfg.scale_factor))
        return pyr, image_ops.build_atlas(pyr)

    res = {n: {} for n in COMPARE}
    pyr2, atlas2 = pyramid_atlas(list(lefts) + list(rights))
    for tag, (pyr, atlas) in (("b16", pyramid_atlas(imgs)), ("b32", (pyr2, atlas2))):
        for name, r in check_extraction_batch(cfg, pyr, atlas, tag).items():
            res[name].update(r)

    # --- K4 over B pairs -------------------------------------------------------
    B = len(lefts)
    f2 = O.extract_from_atlas(atlas2, **extraction_args(cfg))
    fl, fr = O.FrameFeatures(*(f[:B] for f in f2)), O.FrameFeatures(*(f[B:] for f in f2))
    idx_r, have = S.hamming_candidates(fl, fr, cfg.bf, BASELINE, cfg.n_levels, cfg.scale_factor)
    cv, cu, cur, _ = S.level_centres(fl, fr, idx_r, tuple(p[:B] for p in pyr2))
    al, ar = atlas2.image[:B], atlas2.image[B:]
    sargs = (al, ar, cv, cu, cur, fl.level.contiguous(), atlas2.off, atlas2.h, atlas2.w)
    c = compare_sad(*sargs, use=have & fl.valid)
    hold_to_limits("sad_stereo", c, f"{B} pairs")
    log(f"  sad_stereo B={B} pairs: max_abs_err {c['max_abs_err']:.3g}, same best shift "
        f"{c['same']:.5f} of {c['of']} candidates")
    K4 = cv.shape[-1]
    r = {"max_abs_err": c["max_abs_err"], "mismatches": c["mismatches"],
         **kernel_times(lambda: ck.sad_stereo(*sargs), "sad_stereo"),
         **reference_times(lambda: ck.sad_stereo_plain(*sargs), "plain")}
    r["bound_ms"], r["bound_by"] = bound_ms(B * K4 * ((121 + 231) * 4 + 4 * 4 + 11 * 4),
                                            B * K4 * 11 * 121 * 3)
    res["sad_stereo"].update({f"{k}_b16": v for k, v in r.items()})
    return res


class _Keeping:
    """A wrapper in a kernel wrapper's place in its module: keeps the first
    input of each shape, then calls the wrapper.  The wrapper counts its
    launches in ``<its module-level name>.launches``, which names this
    stand-in while it is in place, so the count is passed through."""

    def __init__(self, fn, seen: dict):
        self.fn, self.seen = fn, seen

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args):
        import torch

        key = tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
                    for a in args)
        if key not in self.seen:
            self.seen[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        return self.fn(*args)


class KernelInputs:
    """While a lap runs, keeps the inputs of each kernel wrapper's first call
    at every distinct shape (a copy on the device), so that the kernel can be
    held against its plain version on exactly what the lap gave it; the
    wrapper itself is called as before and counts its launch as before."""

    def __init__(self):
        self.seen = {name: {} for name in COMPARE}

    def __enter__(self):
        from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

        self.orig = {name: getattr(ck, name) for name in COMPARE}
        for name, fn in self.orig.items():
            setattr(ck, name, _Keeping(fn, self.seen[name]))
        return self

    def __exit__(self, *exc):
        from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

        for name, fn in self.orig.items():
            setattr(ck, name, fn)

    def check(self, lap: str) -> dict:
        """Every kept input against the plain version; returns {name: the
        largest max_abs_err over them}."""
        out = {}
        for name, inputs in self.seen.items():
            for args in inputs.values():
                c = COMPARE[name](*args)
                shape = tuple(args[0].shape)
                hold_to_limits(name, c, f"{lap}, input {shape}")
                log(f"  [{lap}] {name} on the lap's input {shape}: {c['mismatches']} of "
                    f"{c['of']} differ, max_abs_err {c['max_abs_err']:.3g}")
                out[name] = max(out.get(name, 0.0), c["max_abs_err"])
        self.seen = {name: {} for name in COMPARE}
        return out


def check_dense_fast(cfg, left_u8, dev) -> dict:
    """K1's single-level form (``fast_score``, the dense score map) on lap
    frame 0's full-size level, against its plain version, timed; off every
    lap's path (the laps launch it 0 times)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    img = torch.as_tensor(left_u8, dtype=torch.float32).to(dev)
    out, ref = ck.fast_score(img), ck.fast_score_plain(img)
    torch.cuda.synchronize()
    mism = int((out != ref).sum())
    log(f"  fast_score (dense, {tuple(img.shape)}): {mism} of {img.numel()} scores differ")
    if mism:
        raise AssertionError("the dense K1 must match its plain version exactly")
    return {"max_abs_err": float((out - ref).abs().max()), "mismatches": mism,
            **kernel_times(lambda: ck.fast_score(img), "fast_score"),
            **reference_times(lambda: ck.fast_score_plain(img), "plain"),
            "library_ms": None,
            # every pixel read and its score written; 16 ring differences, 4 x
            # 16 minima and as many maxima, 2 x 15 + 1 to reduce them
            "bytes": 8 * img.numel(), "ops": (16 + 128 + 31) * img.numel()}


def lap_errors(slam, poses):
    """(positions, metric RMSE against ground truth, tracked frames)."""
    n = len(poses)
    est = slam.positions()
    if est.shape != (n, 3) or not np.all(np.isfinite(est)):
        raise AssertionError(f"positions: shape {est.shape}, finite {np.isfinite(est).all()}")
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    err = np.linalg.norm(est - (gt - twc0) @ Rwc0, axis=1)
    tracked = sum(r.state == "OK" for r in slam.trajectory)
    return est, float(np.sqrt((err ** 2).mean())), tracked


def check_common(tag, ref, launches, want, tracked, rmse):
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")
    if tracked < ref["tracked"] - TRACKED_MARGIN:
        raise AssertionError(f"{tag}: tracked {tracked} < {ref['tracked']} - {TRACKED_MARGIN}")
    rmse_max = RMSE_FACTOR * ref["rmse_m"] + RMSE_SLACK_M
    if rmse > rmse_max:
        raise AssertionError(f"{tag}: rmse {rmse:.5f} m > {rmse_max:.5f} m")


def run_rgbd_lap(cfg, poses, frames, ref, dev) -> dict:
    """``RGBDSLAM`` in localisation mode over the lap, held to the JAX run."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import RGBDSLAM

    n = len(frames)
    slam = RGBDSLAM(cfg, device=dev)
    slam.set_localization_mode(True)
    ms = []
    ck.reset_launch_counts()
    for i, (img, _, depth) in enumerate(frames):
        t0 = time.perf_counter()
        slam.process(img, depth, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = ck.launch_counts()

    states = [r.state for r in slam.trajectory]
    est, rmse, tracked = lap_errors(slam, poses)
    pos_diff = np.linalg.norm(est - np.asarray(ref["positions"]), axis=1)
    state_diff = [i for i, (a, b) in enumerate(zip(states, ref["states"])) if a != b]
    for i in range(n):
        log(f"[rgbd] frame {i:2d} {states[i]:<8} inliers {slam.trajectory[i].n_inliers:4d} "
            f"(JAX {ref['n_inliers'][i]:4d})  {ms[i]:8.2f} ms  |dp| vs JAX {pos_diff[i]:.2e} m")
    log(f"[rgbd] tracked {tracked}/{n} (JAX {ref['tracked']}), rmse {rmse:.5f} m "
        f"(JAX {ref['rmse_m']:.5f}), max |dp| vs JAX {pos_diff.max():.3e} m, "
        f"median {np.median(ms[1:]):.2f} ms/frame after the initialisation frame")
    log(f"[rgbd] launches {launches}")
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    check_common("rgbd lap", ref, launches, want, tracked, rmse)
    if state_diff:
        raise AssertionError(f"rgbd lap: states differ from the JAX run at frames {state_diff}")
    if pos_diff.max() > POS_TOL_M:
        raise AssertionError(f"rgbd lap: positions differ from the JAX run by {pos_diff.max():.4f} m")
    return launches


def run_stereo_lap(cfg, poses, frames, ref, dev) -> dict:
    """``StereoSLAM`` over the lap's rectified pairs, full SLAM, held to the
    JAX run's aggregates: with a mapper one flipped inlier decision moves a
    keyframe to another frame, so frames are not compared one by one."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import StereoSLAM

    n = len(frames)
    slam = StereoSLAM(cfg, device=dev)
    ms, is_kf, n_mp0 = [], [], 0
    ck.reset_launch_counts()
    for i, (left, right, _) in enumerate(frames):
        before = slam.kf_inserted
        t0 = time.perf_counter()
        slam.process(left, right, i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        is_kf.append(slam.kf_inserted > before)
        if i == 0:
            n_mp0 = slam.n_mp
    launches = ck.launch_counts()

    est, rmse, tracked = lap_errors(slam, poses)
    pos_diff = np.linalg.norm(est - np.asarray(ref["positions"]), axis=1)
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    for i, rec in enumerate(slam.trajectory):
        log(f"[stereo] frame {i:2d} {rec.state:<8} inliers {rec.n_inliers:4d} "
            f"(JAX {ref['n_inliers'][i]:4d}) {'KF' if is_kf[i] else '  '} {ms[i]:8.2f} ms  "
            f"|dp| vs JAX {pos_diff[i]:.2e} m")
    ms = np.asarray(ms)
    kf = np.asarray(is_kf)
    steady = np.arange(n) > 0
    log(f"[stereo] tracked {tracked}/{n} (JAX {ref['tracked']}), rmse {rmse:.5f} m "
        f"(JAX {ref['rmse_m']:.5f}), keyframes {slam.n_kf} at {kf_frames} "
        f"(JAX {ref['n_kf']} at {ref['kf_frame_ids']}), map points {slam.n_mp} "
        f"(JAX {ref['n_mp']}), after frame 0 {n_mp0} (JAX {ref['n_mp_frame0']}), "
        f"max |dp| vs JAX {pos_diff.max():.3e} m")
    log(f"[stereo] median {np.median(ms[steady & ~kf]):.2f} ms/frame without a keyframe "
        f"insertion ({int((steady & ~kf).sum())} frames), "
        f"{np.median(ms[steady & kf]):.2f} ms/frame with one ({int((steady & kf).sum())} frames)")
    log(f"[stereo] launches {launches}")
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": n,
            "fast_score": 0}
    check_common("stereo lap", ref, launches, want, tracked, rmse)
    if abs(slam.n_kf - ref["n_kf"]) > KF_MARGIN or slam.n_kf < KF_MIN:
        raise AssertionError(f"stereo lap: {slam.n_kf} keyframes, JAX run {ref['n_kf']}")
    if abs(n_mp0 - ref["n_mp_frame0"]) > INIT_MAP_RTOL * ref["n_mp_frame0"]:
        raise AssertionError(f"stereo lap: initial map {n_mp0} points, JAX run {ref['n_mp_frame0']}")
    return launches


class DispatchCounter:
    """Counts a facade's extraction dispatches: each batch of tracking
    (``_batch_track``), each batch of initialisation attempts
    (``_init_consume_timed``) and each frame-by-frame frame (``process``)."""

    def __init__(self, slam, methods):
        self.n = {m: 0 for m in methods}
        for m in methods:
            setattr(slam, m, self._wrap(m, getattr(slam, m)))

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            self.n[name] += 1
            return fn(*args, **kw)
        return counted


def drive_batches(slam, frames, ids, per_frame_until_init: bool):
    """``process`` until initialised where asked, then ``process_batch`` in
    batches of ``BATCH``; returns the lap's wall seconds (the card synced at
    the end)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while per_frame_until_init and i < len(frames) and slam.state == "NOT_INITIALIZED":
        slam._process_one(frames[i], ids[i])
        i += 1
    while i < len(frames):
        j = min(i + BATCH, len(frames))
        slam.process_batch(frames[i:j], ids[i:j])
        i = j
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fixture_draws(ref: dict):
    """A stand-in for ``MonoSLAM._minimal_sets`` that returns the JAX run's
    RANSAC minimal sets (``init_draws`` of the fixture, by seed), so that the
    port's initialisation attempts test the hypotheses the JAX package's
    did; it keeps each attempt batch's match mask, (seed, mask), for
    :func:`match_mask_agreement`.  Asked for draws the JAX run never made,
    it raises: the port then initialises in another batch than JAX did."""
    import base64

    import torch

    by_seed = {d["seed"]: d for d in ref["init_draws"]}
    asked = []

    def draws(valid, seed):
        d = by_seed.get(int(seed))
        if d is None or list(valid.shape) != d["shape"][:-2] + [d["n"]]:
            raise AssertionError(
                f"mono lap: initialisation attempts with seed {seed}, masks {tuple(valid.shape)}; "
                f"the JAX run drew for {[(x['seed'], x['shape']) for x in ref['init_draws']]}")
        asked.append((int(seed), valid))
        sets = np.frombuffer(base64.b64decode(d["sets"]), "<i2").reshape(d["shape"])
        return torch.from_numpy(sets.astype(np.int64)).to(valid.device)

    draws.asked = asked
    return draws


def match_mask_agreement(ref: dict, asked) -> tuple[int, int, int, int]:
    """(attempts whose match mask equals the JAX run's, attempts, mask
    entries that differ, entries) over the attempts the lap made."""
    import base64

    by_seed = {d["seed"]: d for d in ref["init_draws"]}
    same = rows = diff = entries = 0
    for seed, valid in asked:
        d = by_seed[seed]
        packed = np.frombuffer(base64.b64decode(d["matched"]), np.uint8).reshape(
            *d["shape"][:-2], -1)
        jax_mask = np.unpackbits(packed, axis=-1, count=d["n"]).astype(bool)
        port = valid.cpu().numpy()
        same += int((port == jax_mask).all(axis=-1).sum())
        rows += int(np.prod(port.shape[:-1]))
        diff += int((port != jax_mask).sum())
        entries += port.size
    return same, rows, diff, entries


def run_mono_lap(poses, imgs, ref, dev, smi) -> tuple[dict, float]:
    """``MonoSLAM.process_batch`` over ``bench.py``'s lap from frame 0, on
    the JAX run's RANSAC draws, held to the JAX run; returns (launch counts,
    frames/s)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    n = len(imgs)
    staged = torch.from_numpy(imgs).to(dev)        # staged on the card once, as bench.py does
    frames = [staged[i] for i in range(n)]
    slam = MonoSLAM(mono_config(loop_closing=True), device=dev)
    slam._minimal_sets = draws = fixture_draws(ref)
    count = DispatchCounter(slam, ("_batch_track", "_init_consume_timed"))
    ck.reset_launch_counts()
    wall = drive_batches(slam, frames, list(range(n)), per_frame_until_init=False)
    slam.flush()
    launches = ck.launch_counts()
    check_loops("mono lap", slam, ref)
    same, rows, diff, entries = match_mask_agreement(ref, draws.asked)
    log(f"[mono] RANSAC: the JAX run's draws for seeds {[s for s, _ in draws.asked]}; the "
        f"port's match masks equal the JAX run's in {same} of {rows} attempts ({diff} of "
        f"{entries} entries differ)")

    states = [r.state for r in slam.trajectory]
    if len(states) != n:
        raise AssertionError(f"mono lap: {len(states)} records for {n} frames")
    est = slam.positions()
    if not np.all(np.isfinite(est)):
        raise AssertionError("mono lap: non-finite positions")
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    init = next((i for i, st in enumerate(states) if st == "OK"), None)
    if init is None or not kf_frames:
        raise AssertionError(f"mono lap: never initialised (states {states[:20]}...)")
    use = [kf_frames[0]] + list(range(init, n))
    gt = np.asarray([t for _, t in poses])
    ate, _, (_, _, scale) = ate_rmse(est[use], gt[use], with_scale=True)
    tracked = sum(st == "OK" for st in states)
    for i, rec in enumerate(slam.trajectory):
        if i < init + 2 or i % 10 == 0 or rec.state != "OK":
            log(f"[mono] frame {i:3d} {rec.state:<16} inliers {rec.n_inliers:4d} "
                f"(JAX {ref['n_inliers'][i]:4d})")
    fps = n / wall
    log(f"[mono] initialised at frame {init} (JAX {ref['init_frame']}), tracked {tracked}/{n} "
        f"(JAX {ref['tracked']}), Sim(3) ATE {ate:.5f} (JAX {ref['ate_m']:.5f}, scale {scale:.3f}), "
        f"keyframes {slam.n_kf} at {kf_frames} (JAX {ref['n_kf']} at {ref['kf_frame_ids']}), "
        f"map points {slam.n_mp} (JAX {ref['n_mp']})")
    log(f"[mono] {fps:.2f} frames/s over the {n}-frame lap ({wall:.2f} s, initialisation "
        f"included; {smi})")
    dispatches = sum(count.n.values())
    log(f"[mono] launches {launches}; extraction dispatches {count.n}")
    want = {"fast_candidates": dispatches, "gaussian_blur7": dispatches,
            "brief_sample": dispatches, "sad_stereo": 0, "fast_score": 0}
    if launches != want:
        raise AssertionError(f"mono lap: launch counts {launches}, expected {want}")
    if init > ref["init_frame"] + MONO_INIT_MARGIN:
        raise AssertionError(f"mono lap: initialised at {init}, JAX at {ref['init_frame']}")
    if tracked < ref["tracked"] - MONO_TRACKED_MARGIN:
        raise AssertionError(f"mono lap: tracked {tracked} < {ref['tracked']} - {MONO_TRACKED_MARGIN}")
    if ate > RMSE_FACTOR * ref["ate_m"] + RMSE_SLACK_M:
        raise AssertionError(f"mono lap: ATE {ate:.5f} > 2 x {ref['ate_m']:.5f} + 2 mm")
    if abs(slam.n_kf - ref["n_kf"]) > MONO_KF_MARGIN:
        raise AssertionError(f"mono lap: {slam.n_kf} keyframes, JAX run {ref['n_kf']}")
    return launches, fps


def reloc_inputs(ref: dict):
    """(ground-truth camera centres, [(frame id, (H, W) uint8 image or the
    blank frame)]) of the kidnapped lap: the mono lap's trajectory, rendered
    from the rotations the JAX run rendered (the revisit rolled 90 deg),
    which the fixture stores per frame."""
    import base64

    from orb_slam3_noted_tpu_torch.utils.synthetic import orbit_trajectory

    n = ref["frames"]
    rwc = np.frombuffer(base64.b64decode(ref["rwc_f32"]), "<f4").reshape(n, 3, 3)
    traj = orbit_trajectory(ref["trajectory_frames"], forward=0.03, yaw0=0.45)
    shown = [(fid, k, R) for fid, k, R in zip(ref["frame_ids"], ref["pose_index"], rwc)
             if k is not None]
    imgs = dict(zip([fid for fid, _, _ in shown],
                    render([("mono", R.copy(), traj[k][1]) for _, k, R in shown])))
    blank = np.full((H, W), 128, np.uint8)
    centres = [traj[k][1] if k is not None else np.full(3, np.nan) for k in ref["pose_index"]]
    return np.asarray(centres), [(fid, imgs.get(fid, blank)) for fid in ref["frame_ids"]]


def jax_pnp_mask(a: dict) -> np.ndarray:
    """The match mask of one of the fixture's PnP attempts."""
    import base64

    return np.unpackbits(np.frombuffer(base64.b64decode(a["valid"]), np.uint8),
                         count=a["n"]).astype(bool)


def fixture_pnp_draws(ref: dict, slam):
    """A stand-in for ``MonoSLAM._pnp_sets`` that returns the JAX run's PnP
    minimal sets for the same frame and candidate (``pnp_attempts`` of the
    fixture; the candidate is read from ``tracking.reloc_matches``, which
    runs just before) where the port's match mask is the JAX run's, so that
    the port's PnP tests the hypotheses the JAX package's did.  Elsewhere
    (another candidate, or other matches: the JAX run's indices would then
    point at non-matches) it returns the port's own draw.  Each attempt's
    (frame, slot, mask, whether the draw was the JAX run's) is kept."""
    import base64

    import torch

    from orb_slam3_noted_tpu_torch.pipeline import tracking as T

    by_key = {(a["frame_id"], a["slot"]): a for a in ref["pnp_attempts"]}
    own = slam._pnp_sets
    cur, asked = {}, []
    matches = T.reloc_matches

    def reloc_matches(m, cand, feats, cam):
        cur["slot"] = int(cand)
        return matches(m, cand, feats, cam)

    def draws(valid, seed):
        a = by_key.get((int(seed), cur["slot"]))
        same = a is not None and np.array_equal(valid.cpu().numpy(), jax_pnp_mask(a))
        asked.append((int(seed), cur["slot"], valid, same))
        if not same:
            return own(valid, seed)
        sets = np.frombuffer(base64.b64decode(a["sets"]), "<i2").reshape(a["shape"])
        return torch.from_numpy(sets.astype(np.int64)).to(valid.device)

    draws.asked, draws.reloc_matches, draws.original = asked, reloc_matches, matches
    return draws


class AttemptParts:
    """While ``on``, times the parts of a relocalisation attempt on the host
    clock with the card synchronised before and after each: every function
    put in place by ``add`` adds its ms to ``cur``; while off it only calls
    through.  ``restore`` puts the originals back."""

    def __init__(self):
        self.on, self.cur, self.orig = False, {}, {}

    def add(self, obj, attr):
        import torch

        if (obj, attr) in self.orig:
            return
        fn = self.orig[(obj, attr)] = getattr(obj, attr)

        def timed(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.cur[attr] = self.cur.get(attr, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        setattr(obj, attr, timed)

    def restore(self):
        for (obj, attr), fn in self.orig.items():
            setattr(obj, attr, fn)


def run_reloc_lap(ref, dev, smi) -> tuple[dict, dict]:
    """The kidnapped monocular lap: ``MonoSLAM.process`` frame by frame at
    ``bench.py``'s monocular configuration on the JAX run's two-view and PnP
    draws, held to the JAX run (``tests/fixtures/mono_reloc_lap.json``).
    Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline import system as S
    from orb_slam3_noted_tpu_torch.pipeline import tracking as T
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    centres, frames = reloc_inputs(ref)
    n = len(frames)
    ids = [f for f, _ in frames]
    staged = torch.from_numpy(np.stack([img for _, img in frames])).to(dev)
    slam = S.MonoSLAM(mono_config(), device=dev)
    slam._minimal_sets = init_draws = fixture_draws(ref)
    slam._pnp_sets = pnp_draws = fixture_pnp_draws(ref, slam)
    attempts, relocs, pnp_counts = [], [], []
    reloc, pnp_fn = slam._try_relocalize, S.PNP.pnp_ransac

    parts, part_ms = AttemptParts(), []

    def timed_reloc(feats, frame_id):
        if slam.reloc_db is not None:
            parts.add(slam.reloc_db, "compute_bow")
            parts.add(slam.reloc_db, "detect_candidates")
        parts.cur, parts.on = {}, True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reloc(feats, frame_id)
        torch.cuda.synchronize()
        parts.on = False
        attempts.append((int(frame_id), (time.perf_counter() - t0) * 1e3, out is not None))
        part_ms.append({k: round(v, 3) for k, v in parts.cur.items()})
        if out is not None:  # the attempt's last PnP is the one that succeeded
            relocs.append({"frame_id": int(frame_id), "slot": int(slam.last_kf_slot),
                           "pnp_inliers": int(pnp_counts[-1]), "retrack_inliers": int(out[2])})
        return out

    def counted_pnp(*args, **kw):
        res = pnp_fn(*args, **kw)
        pnp_counts.append(res.n_inliers)
        return res

    slam._try_relocalize = timed_reloc
    T.reloc_matches, S.PNP.pnp_ransac = pnp_draws.reloc_matches, counted_pnp
    for obj, attr in ((S.MS, "covisibility_matrix"), (S.MS, "local_map_mask"),
                      (T, "track_frame"), (T, "reloc_matches"), (S.PNP, "pnp_ransac"),
                      (slam, "_pnp_sets")):
        parts.add(obj, attr)
    ck.reset_launch_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, fid in enumerate(ids):
            slam.process(staged[i], fid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        parts.restore()
        T.reloc_matches, S.PNP.pnp_ransac = pnp_draws.original, pnp_fn
    launches = ck.launch_counts()

    states = [r.state for r in slam.trajectory]
    if len(states) != n:
        raise AssertionError(f"reloc lap: {len(states)} records for {n} frames")
    est = slam.positions()
    if not np.all(np.isfinite(est)):
        raise AssertionError("reloc lap: non-finite positions")
    poses = slam.final_poses()
    if len(poses) != n or not all(np.all(np.isfinite(R)) and np.all(np.isfinite(t)) for R, t in poses):
        raise AssertionError("reloc lap: final_poses() is not one finite pose per frame")
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    init = next((i for i, st in enumerate(states) if st == "OK"), None)
    if init is None:
        raise AssertionError(f"reloc lap: never initialised (states {states[:10]}...)")
    blank = np.isnan(centres[:, 0])
    use = [ids.index(kf_frames[0])] + [i for i in range(init, n) if not blank[i]]
    ate, _, (_, _, scale) = ate_rmse(est[use], centres[use], with_scale=True)
    tracked = sum(st == "OK" for st in states)
    for i, rec in enumerate(slam.trajectory):
        j = ref["states"][i]
        if i < init + 2 or i % 10 == 0 or rec.state != "OK" or rec.state != j:
            log(f"[reloc] frame {ids[i]:4d} {rec.state:<16} inliers {rec.n_inliers:4d} "
                f"(JAX {j} {ref['n_inliers'][i]:4d})")

    # the database: one BoW row per keyframe the mapper inserted (the initial
    # map's two are not registered, in either package), each L1-normalised
    db = slam.reloc_db
    if db is None:
        raise AssertionError("reloc lap: no relocalisation database was built")
    rows = [int(s) for s in np.flatnonzero(db.present)]
    live = [int(s) for s in np.flatnonzero(slam.m.kf_valid.cpu().numpy())]
    sums = db.bow_mat[rows].sum(-1).cpu().numpy()
    log(f"[reloc] database rows {rows} (JAX {ref['reloc_db_rows']}), live keyframes {live}, "
        f"row sums {np.round(sums, 6).tolist()}")
    if (set(live) - {0, 1}) - set(rows) or any(slam.kf_frame_ids[r] < 0 for r in rows) \
            or np.abs(sums - 1.0).max() > 1e-4:
        raise AssertionError("reloc lap: the database does not hold one BoW row per keyframe")

    # the PnP draws and masks against the JAX run's
    by_key = {(a["frame_id"], a["slot"]): a for a in ref["pnp_attempts"]}
    for fid, slot, valid, jax_draw in pnp_draws.asked:
        a = by_key.get((fid, slot))
        note = "the port's own draw (no such JAX attempt)"
        if a is not None:
            diff = int((valid.cpu().numpy() != jax_pnp_mask(a)).sum())
            note = (f"{'the JAX run' if jax_draw else 'the port'}'s own draw; match mask {diff} of "
                    f"{a['n']} entries differ (port {int(valid.sum())}, JAX {a['n_valid']} matches)")
        log(f"[reloc] PnP attempt at frame {fid} against slot {slot}: {note}")
    same, rows_, diff, entries = match_mask_agreement(ref, init_draws.asked)
    log(f"[reloc] two-view draws: the port's match masks equal the JAX run's in {same} of {rows_} "
        f"attempts ({diff} of {entries} entries differ)")

    # one keyframe's BoW transform, timed (device time and per call)
    slot = rows[-1]
    desc, valid = slam.m.kf_desc[slot], slam.m.kf_feat_valid[slot]
    bow_fn = lambda: db.compute_bow(desc, valid)
    n_feat, n_words = int(desc.shape[0]), db.n_words
    bow = {"device_ms": device_time_ms(bow_fn), "per_call_ms": cuda_time_ms(bow_fn),
           "ops": 2 * n_feat * n_words * 256, "n_features": n_feat, "n_words": n_words}
    # descriptors, their mask, the packed words and idf read once, the words
    # and the BoW vector written; 2 N W 256 operations in the product
    bow["bound_ms"], bow["bound_by"] = bound_ms(32 * (n_feat + n_words) + 5 * n_feat
                                                + 8 * n_words, bow["ops"])

    # the first relocalisation's attempt again, warm, five times (after the
    # lap: it moves the facade's reference keyframe and motion model)
    warm = []
    if relocs:
        i = ids.index(relocs[0]["frame_id"])
        feats = slam._extract(staged[i].to(torch.float32))
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reloc(feats, ids[i])
            torch.cuda.synchronize()
            warm.append(round((time.perf_counter() - t0) * 1e3, 3))
    with_cands = [ms for f, ms, _ in attempts if not blank[ids.index(f)]]
    fps = n / wall
    meas = {"fps": fps, "wall_s": wall, "reloc_attempts": len(attempts),
            "reloc_attempt_ms": [round(ms, 3) for _, ms, _ in attempts],
            "reloc_attempt_parts_ms": part_ms, "warm_reloc_attempt_ms": warm,
            "reloc_attempt_ms_median": float(np.median([ms for _, ms, _ in attempts])),
            "revisit_attempt_ms": with_cands, "bow_transform": bow,
            "relocalisations": relocs, "tracked": tracked, "ate_m": float(ate), "n_kf": slam.n_kf}
    log(f"[reloc] relocalised {[(r['frame_id'], r['slot'], r['pnp_inliers'], r['retrack_inliers']) for r in relocs]} "
        f"(frame, slot, PnP inliers, re-track inliers; JAX "
        f"{[(r['frame_id'], r['slot'], r['pnp_inliers'], r['retrack_inliers']) for r in ref['relocalisations']]})")
    log(f"[reloc] initialised at frame {ids[init]} (JAX {ref['init_frame']}), tracked {tracked}/{n} "
        f"(JAX {ref['tracked']}), Sim(3) ATE {ate:.5f} over {len(use)} frames (JAX "
        f"{ref['ate_m']:.5f}, scale {scale:.3f}), keyframes {slam.n_kf} at {kf_frames} (JAX "
        f"{ref['n_kf']} at {ref['kf_frame_ids']}), map points {slam.n_mp} (JAX {ref['n_mp']})")
    log(f"[reloc] {len(attempts)} relocalisation attempts, {np.median([ms for _, ms, _ in attempts]):.2f} "
        f"ms median (host clock, card synchronised; {[round(ms, 2) for _, ms, _ in attempts]}); "
        f"the revisit's {[round(m, 2) for m in with_cands]}, by part {part_ms[-len(with_cands):]}; "
        f"the first relocalisation's attempt again, warm: {warm} ms; one keyframe's BoW transform "
        f"({n_feat} x {n_words} words) {bow['device_ms']:.4f} ms device, {bow['per_call_ms']:.4f} "
        f"ms per call, bound {bow['bound_ms']:.4f} ({bow['bound_by']}); {fps:.2f} frames/s over "
        f"the {n}-frame lap ({wall:.2f} s; {smi})")
    log(f"[reloc] launches {launches}")

    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"reloc lap: launch counts {launches}, expected {want} (one a frame)")
    jrel = ref["relocalisations"]
    if len(relocs) != len(jrel):
        raise AssertionError(f"reloc lap: {len(relocs)} relocalisations, JAX {len(jrel)}")
    for r, j in zip(relocs, jrel):
        if ids.index(r["frame_id"]) > ids.index(j["frame_id"]) + RELOC_FRAME_MARGIN \
                or r["slot"] != j["slot"]:
            raise AssertionError(f"reloc lap: relocalised at {r}, JAX at {j}")
        if r["pnp_inliers"] < RELOC_PNP_SHARE * j["pnp_inliers"]:
            raise AssertionError(f"reloc lap: PnP inliers {r['pnp_inliers']}, JAX {j['pnp_inliers']}")
    if tracked < ref["tracked"] - MONO_TRACKED_MARGIN:
        raise AssertionError(f"reloc lap: tracked {tracked} < {ref['tracked']} - {MONO_TRACKED_MARGIN}")
    if ate > RMSE_FACTOR * ref["ate_m"] + RMSE_SLACK_M:
        raise AssertionError(f"reloc lap: ATE {ate:.5f} > 2 x {ref['ate_m']:.5f} + 2 mm")
    if abs(slam.n_kf - ref["n_kf"]) > MONO_KF_MARGIN:
        raise AssertionError(f"reloc lap: {slam.n_kf} keyframes, JAX run {ref['n_kf']}")
    return launches, meas


def run_stereo_batch_lap(cfg, poses, frames, ref, dev, smi) -> tuple[dict, float]:
    """``StereoSLAM``: ``process`` until initialised, then ``process_batch``
    in batches of 16 over the lap's pairs (staged on the card), held to the
    JAX run; returns (launch counts, frames/s)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import StereoSLAM

    n = len(frames)
    staged = torch.from_numpy(np.stack([f[0] for f in frames] + [f[1] for f in frames])).to(dev)
    pairs = [(staged[i], staged[n + i]) for i in range(n)]
    slam = StereoSLAM(dataclasses.replace(cfg, enable_loop_closing=True), device=dev)
    count = DispatchCounter(slam, ("_batch_track", "process"))
    ck.reset_launch_counts()
    wall = drive_batches(slam, pairs, list(range(n)), per_frame_until_init=True)
    slam.flush()
    launches = ck.launch_counts()
    check_loops("stereo batch lap", slam, ref)

    est, rmse, tracked = lap_errors(slam, poses)
    kf_frames = sorted(int(f) for f in slam.kf_frame_ids if f >= 0)
    fps = n / wall
    log(f"[stereo batch] tracked {tracked}/{n} (JAX {ref['tracked']}), rmse {rmse:.5f} m "
        f"(JAX {ref['rmse_m']:.5f}), keyframes {slam.n_kf} at {kf_frames} (JAX {ref['n_kf']} at "
        f"{ref['kf_frame_ids']}), map points {slam.n_mp} (JAX {ref['n_mp']})")
    log(f"[stereo batch] {fps:.2f} frames/s over the {n}-pair lap ({wall:.2f} s; {smi})")
    dispatches = sum(count.n.values())
    log(f"[stereo batch] launches {launches}; extraction dispatches {count.n}")
    want = {"fast_candidates": dispatches, "gaussian_blur7": dispatches,
            "brief_sample": dispatches, "sad_stereo": dispatches, "fast_score": 0}
    check_common("stereo batch lap", ref, launches, want, tracked, rmse)
    if abs(slam.n_kf - ref["n_kf"]) > KF_MARGIN:
        raise AssertionError(f"stereo batch lap: {slam.n_kf} keyframes, JAX run {ref['n_kf']}")
    return launches, fps


def check_loops(tag: str, slam, ref: dict) -> None:
    """A lap with loop closing on: the loop closer was built, nothing is left
    queued after ``flush()``, and it closed as many loops as the JAX run."""
    lc = slam.loop_closer
    if lc is None or slam._pending_loops or lc.active_gba is not None:
        raise AssertionError(f"{tag}: loop closer {lc}, {len(slam._pending_loops)} queued")
    log(f"[{tag}] loop closing on: {lc.loops_closed} loops closed (JAX {ref['loops_closed']}), "
        f"{int(lc.db.present.sum())} keyframes in the database")
    if lc.loops_closed != ref["loops_closed"]:
        raise AssertionError(f"{tag}: {lc.loops_closed} loops closed, JAX {ref['loops_closed']}")


def _scaffold():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import loop_scaffold

    return loop_scaffold


_LOOP_FRAMES = {}


def loop_inputs(ref: dict, arm: str | None = None):
    """((camera-to-world rotations (n, 3, 3), camera centres (n, 3)), (n, H,
    W) uint8 images) of ``bench.py``'s 400-frame pendulum lap, rendered from
    the JAX run's camera poses (the wide arm's own where ``arm`` has them),
    the first ``frames`` of ``arm`` where one is named (all 400 else)."""
    import base64

    n = ref["frames"] if arm is None else ref[arm]["frames"]
    src = ref[arm] if arm is not None and "rwc_f32" in ref[arm] else ref
    rwc = np.frombuffer(base64.b64decode(src["rwc_f32"]), "<f4").reshape(-1, 3, 3)[:n]
    twc = np.frombuffer(base64.b64decode(src["twc_f64"]), "<f8").reshape(-1, 3)[:n]
    key = (rwc.tobytes(), twc.tobytes())
    if key not in _LOOP_FRAMES:  # both arms of bench.py's lap share one render
        _LOOP_FRAMES.clear()
        _LOOP_FRAMES[key] = np.stack(render([("mono", R, t) for R, t in zip(rwc, twc)]))
    return (rwc, twc), _LOOP_FRAMES[key]


def fixture_sim3_draws(records: list, own):
    """A stand-in for ``LoopCloser._sim3_sets``: the JAX run's Sim(3) RANSAC
    sets where it drew for the same slot on the same pair mask, else the
    port's own draw (``own``).  ``stats`` counts the calls and the calls
    whose mask equalled the JAX run's."""
    import base64

    import torch

    by_slot = {}
    for r in records:
        mask = np.unpackbits(np.frombuffer(base64.b64decode(r["valid"]), np.uint8),
                             count=r["n"]).astype(bool)
        sets = np.frombuffer(base64.b64decode(r["sets"]), "<i2").reshape(r["shape"])
        by_slot.setdefault(r["slot"], []).append((mask, sets))
    stats = {"calls": 0, "same_mask": 0}

    def draws(valid, slot):
        stats["calls"] += 1
        v = valid.cpu().numpy()
        for mask, sets in by_slot.get(int(slot), ()):
            if np.array_equal(mask, v):
                stats["same_mask"] += 1
                return torch.from_numpy(sets.astype(np.int64)).to(valid.device)
        return own(valid, slot)

    draws.stats = stats
    return draws


def rotation_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations, in degrees."""
    cos = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def loop_truth(poses, f_cur: int, f_cand: int, R, t) -> dict:
    """How far an accepted loop's Sim(3) (S_cur_cand: candidate camera ->
    current camera) is from the truth: the angle between its rotation and
    the true relative rotation, and between its translation (the
    candidate's centre in the current camera, in map units) and the true
    one's direction (metres), in degrees."""
    rwc, twc = poses
    R_gt = rwc[f_cur].T @ rwc[f_cand]
    t_gt = rwc[f_cur].T @ (twc[f_cand] - twc[f_cur])
    cos_t = float(np.dot(t, t_gt) / max(np.linalg.norm(t) * np.linalg.norm(t_gt), 1e-12))
    return {"rot_err_deg": rotation_deg(R, R_gt),
            "dir_err_deg": float(np.degrees(np.arccos(np.clip(cos_t, -1.0, 1.0)))),
            "baseline_m": float(np.linalg.norm(t_gt))}


def run_loop_arm(frames, poses, loop_on: bool, dev, ref: dict | None = None) -> tuple[dict, dict]:
    """One arm of ``bench.py``'s accuracy lap (``bench.py:251-278``):
    ``MonoSLAM.process_batch`` in batches of 16 with ``bench.py``'s keyframe
    override, ``flush()`` at the end; with loop closing off,
    ``_maybe_close_loop`` is ``_register_reloc_kf``.  With ``ref`` (the JAX
    run's arm) on its two-view draws and, where the pair masks agree, its
    Sim(3) draws.  Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    n = len(frames)
    gt = poses[1]
    s = MonoSLAM(mono_config(loop_closing=True), device=dev)
    if ref is not None:
        s._minimal_sets = two_view = fixture_draws(ref)
    if not loop_on:
        s._maybe_close_loop = lambda slot, feats: s._register_reloc_kf(slot)
    base_need = s._need_new_kf

    def need_kf(n_inl, **kw):
        # a keyframe at least every 8 tracked frames (bench.py:259-270)
        if base_need(n_inl, **kw):
            return True
        return s.frames_since_kf >= 8 and n_inl > 15 and s._can_insert_kf()

    s._need_new_kf = need_kf
    det = {"detections": 0, "drain_ms": [], "sim3": None, "accepted": []}
    build = s._maybe_build_loop_closer

    def build_and_watch(feats):
        fresh = s.loop_closer is None
        build(feats)
        if fresh:
            lc = s.loop_closer
            if ref is not None:
                lc._sim3_sets = det["sim3"] = fixture_sim3_draws(ref["sim3_ransac"], lc._sim3_sets)
            start, finish = lc.start_detect, lc.finish_detect_many

            def start_detect(slam, slot):
                det["detections"] += 1
                return start(slam, slot)

            def finish_many(slam, pendings):
                t0 = time.perf_counter()
                out = finish(slam, pendings)
                torch.cuda.synchronize()
                det["drain_ms"].append((time.perf_counter() - t0) * 1e3)
                return out

            lc.start_detect, lc.finish_detect_many = start_detect, finish_many
            accept = lc._accept

            def accept_and_record(slam, slot, cand, res, covis=None):
                f_cur, f_cand = int(slam.kf_frame_ids[slot]), int(slam.kf_frame_ids[cand])
                R, t, sc = (x.cpu().numpy() for x in (res.R, res.t, res.s))
                det["accepted"].append({"slots": [int(slot), int(cand)], "frames": [f_cur, f_cand],
                                        "s": float(sc), "R": R.tolist(), "t": t.tolist(),
                                        **loop_truth(poses, f_cur, f_cand, R, t)})
                return accept(slam, slot, cand, res, covis)

            lc._accept = accept_and_record

    s._maybe_build_loop_closer = build_and_watch
    count = DispatchCounter(s, ("_batch_track", "_init_consume_timed"))
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    walls = []
    t0 = time.perf_counter()
    for i in range(0, n, BATCH):
        j = min(i + BATCH, n)
        tb = time.perf_counter()
        s.process_batch(frames[i:j], list(range(i, j)))
        walls.append(time.perf_counter() - tb)
    s.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()

    states = [r.state for r in s.trajectory]
    idx = [k for k, st in enumerate(states) if st == "OK"]
    est = s.positions()
    if len(states) != n or not np.all(np.isfinite(est)):
        raise AssertionError(f"loop lap: {len(states)} records for {n} frames, or not finite")
    ate, _, (_, _, scale) = ate_rmse(est[idx], gt[[s.trajectory[k].frame_id for k in idx]],
                                     with_scale=True)
    lat = np.asarray(walls[1:]) * 1e3  # bench.py skips the initialisation batch
    dispatches = sum(count.n.values())
    want = {"fast_candidates": dispatches, "gaussian_blur7": dispatches,
            "brief_sample": dispatches, "sad_stereo": 0, "fast_score": 0}
    if launches != want:
        raise AssertionError(f"loop lap: launch counts {launches}, expected {want}")
    meas = {
        "frames": n, "loop_closing": loop_on,
        "init_frame": states.index("OK") if "OK" in states else None,
        "tracked": len(idx), "ate_m": float(ate), "ate_scale": float(scale), "n_kf": s.n_kf,
        "kf_inserted": s.kf_inserted, "n_mp": s.n_mp,
        "loops_closed": s.loop_closer.loops_closed if s.loop_closer else 0,
        "detections": det["detections"], "fps": n / wall, "wall_s": wall,
        "batch_ms_p50": float(np.median(lat)), "batch_ms_max": float(lat.max()),
        "drain_ms_median": float(np.median(det["drain_ms"])) if det["drain_ms"] else None,
        "drain_ms_max": float(max(det["drain_ms"])) if det["drain_ms"] else None,
        "drains": len(det["drain_ms"]), "dispatches": dispatches,
        "accepted": det["accepted"],
    }
    if ref is not None:
        same, rows, _, _ = match_mask_agreement(ref, two_view.asked)
        meas["two_view_masks_same"] = [same, rows]
        if det["sim3"] is not None:
            meas["sim3_masks_same"] = [det["sim3"].stats["same_mask"], det["sim3"].stats["calls"]]
    return launches, meas


def check_loop_arm(tag: str, got: dict, ref: dict) -> None:
    if got["init_frame"] is None or got["init_frame"] > ref["init_frame"] + LOOP_INIT_MARGIN:
        raise AssertionError(f"{tag}: initialised at {got['init_frame']}, JAX at {ref['init_frame']}")
    if got["tracked"] < ref["tracked"] - LOOP_TRACKED_MARGIN:
        raise AssertionError(f"{tag}: tracked {got['tracked']} < {ref['tracked']} - "
                             f"{LOOP_TRACKED_MARGIN}")
    if got["ate_m"] > RMSE_FACTOR * ref["ate_m"] + RMSE_SLACK_M:
        raise AssertionError(f"{tag}: ATE {got['ate_m']:.5f} > 2 x {ref['ate_m']:.5f} + 2 mm")
    if not got["loop_closing"] and got["loops_closed"]:
        raise AssertionError(f"{tag}: a loop closed with loop closing off")
    if got["loops_closed"] != ref["loops_closed"]:
        raise AssertionError(f"{tag}: {got['loops_closed']} loops closed, JAX {ref['loops_closed']}")
    for a in got["accepted"]:
        near = [h for h in ref["sim3_refine"] if h["n_inliers"] >= SIM3_MIN_INLIERS
                and all(abs(x - y) <= LOOP_FRAME_MARGIN for x, y in zip(h["frames"], a["frames"]))]
        a["jax_hypothesis"] = min(
            ({"frames": h["frames"], "n_inliers": h["n_inliers"], "s": h["s"],
              "rot_diff_deg": rotation_deg(np.asarray(h["R"]), np.asarray(a["R"]))} for h in near),
            key=lambda h: h["rot_diff_deg"], default=None)
        if a["jax_hypothesis"] is None or a["jax_hypothesis"]["rot_diff_deg"] > LOOP_SIM3_DEG:
            raise AssertionError(f"{tag}: the loop at frames {a['frames']} is none the JAX run's "
                                 f"ladder put forward: {a['jax_hypothesis']}")
    for j in ref["accepted"]:
        if not any(abs(a["frames"][1] - j["frames"][1]) <= LOOP_FRAME_MARGIN
                   for a in got["accepted"]):
            raise AssertionError(f"{tag}: no loop back to JAX's candidate at frame "
                                 f"{j['frames'][1]}: {got['accepted']}")
    if abs(got["kf_inserted"] - ref["kf_inserted"]) > LOOP_KF_MARGIN:
        raise AssertionError(f"{tag}: {got['kf_inserted']} keyframe insertions, JAX "
                             f"{ref['kf_inserted']}")
    if got["loop_closing"] and got["detections"] != got["kf_inserted"]:
        raise AssertionError(f"{tag}: {got['detections']} detections for {got['kf_inserted']} "
                             f"keyframes inserted after initialisation")


def loop_summary(accepted: list) -> list:
    """The accepted loops without their Sim(3) matrices."""
    return [{k: v for k, v in a.items() if k not in ("R", "t")} for a in accepted]


def loop_metric_line(off: dict, on: dict) -> dict:
    """``bench.py``'s ``mono_400f_loop_ate`` line (``bench.py:283-294``),
    named by the frames the arms ran (``mono_200f_loop_ate`` on phase 10a's
    first 200)."""
    return {"metric": f"mono_{on['frames']}f_loop_ate", "value": round(on["ate_m"], 4),
            "unit": "m", "vs_baseline": round(off["ate_m"] / max(on["ate_m"], 1e-9), 3),
            "ate_loop_off_m": round(off["ate_m"], 4), "loops_closed": int(on["loops_closed"]),
            "tracked_off": off["tracked"], "tracked_on": on["tracked"], "n_frames": on["frames"]}


def run_loop_lap(ref: dict, dev, smi, arm: str) -> tuple[dict, dict]:
    """Phase 10a, one arm: the arm's first frames of the 400-frame lap,
    staged on the card once, held to the JAX run's arm."""
    import torch

    poses, imgs = loop_inputs(ref, arm)
    staged = torch.from_numpy(imgs).to(dev)
    frames = [staged[i] for i in range(len(imgs))]
    loop_on = arm != "loop_off"
    launches, got = run_loop_arm(frames, poses, loop_on, dev, ref=ref[arm])
    r = ref[arm]
    log(f"[loop lap, {arm}] initialised at frame {got['init_frame']} (JAX {r['init_frame']}), "
        f"tracked {got['tracked']}/{len(frames)} (JAX {r['tracked']}), ATE {got['ate_m']:.5f} m "
        f"(JAX {r['ate_m']:.5f}, scale {got['ate_scale']:.3f}), keyframes inserted "
        f"{got['kf_inserted']} (JAX {r['kf_inserted']}), loops closed {got['loops_closed']} "
        f"(JAX {r['loops_closed']}) at {json.dumps(loop_summary(got['accepted']))} (JAX "
        f"{r['accepted']}), "
        f"detections "
        f"{got['detections']}, two-view masks equal "
        f"{got['two_view_masks_same']}, Sim(3) masks equal {got.get('sim3_masks_same')}")
    log(f"[loop lap, {arm}] {got['fps']:.2f} frames/s ({got['wall_s']:.2f} s), batch latency "
        f"p50 {got['batch_ms_p50']:.1f} ms, max {got['batch_ms_max']:.1f} ms; loop_drain "
        f"host ms median {got['drain_ms_median']} max {got['drain_ms_max']} over "
        f"{got['drains']} drains; launches {launches}; {smi}")
    check_loop_arm(f"loop lap, {arm}", got, r)
    if got["accepted"]:
        log(f"[loop lap, {arm}] each loop beside the JAX run's ladder hypothesis for the same "
            f"places: {json.dumps([a['jax_hypothesis'] for a in got['accepted']])}")
    return launches, got


def one_correction(inp, cfg, vocab, idf, ref, dev):
    """The full-width drifted map on the card, a loop closer with every
    earlier keyframe in its database, then the tail's detection
    (``start_detect``, ``finish_detect_many``: the ladder and the
    correction) and the deferred work slice by slice, each timed with the
    card synchronised.  Returns (loop closer, slam, closed, the accepted
    Sim(3), ms by step, Sim(3) draw stats)."""
    import torch

    from orb_slam3_noted_tpu_torch.pipeline import map_state as MS
    from orb_slam3_noted_tpu_torch.pipeline.loop_closing import LoopCloser

    LS = _scaffold()

    def to_dev(a):
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(
            a.view(np.int32) if a.dtype == np.uint32 else a)).to(dev)

    m = LS.build_map(MS, MS.empty_map(cfg, device=dev), inp, to_dev)
    lc = LoopCloser(vocab, cfg.max_keyframes, min_inliers=20, consistency_th=0, idf=idf,
                    device=dev)
    lc._sim3_sets = draws = fixture_sim3_draws(ref["sim3_ransac"], lc._sim3_sets)
    tail = inp["n_kf"] - 1
    for k in range(tail):
        lc.db.add(k, lc.db.compute_bow(m.kf_desc[k], m.kf_feat_valid[k])[1])
    slam = LS.ScaffoldSlam(m, inp["n_kf"], cfg)
    accepted, steps = [], {}
    accept = lc._accept

    def accept_and_keep(slam_, slot, cand, res, covis=None):
        accepted.append(res)
        return accept(slam_, slot, cand, res, covis)

    lc._accept = accept_and_keep

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        steps[name] = (time.perf_counter() - t0) * 1e3
        return out

    pending = timed("detect_enqueue", lc.start_detect, slam, tail)
    closed = timed("detect_finish", lc.finish_detect_many, slam, [pending])
    k = 0
    while lc._post_fuse or lc.active_gba is not None:
        kind = "fuse" if lc._post_fuse else "gba_slice"
        timed(f"{kind}_{k}", lc.service_gba, slam)
        k += 1
    return lc, slam, closed, accepted[0] if accepted else None, steps, draws.stats


def run_loop_correction(ref: dict, dev, smi) -> tuple[dict, dict]:
    """Phase 10b: ``CORR_RUNS`` loop corrections on the full-width drifted
    map (``scripts/loop_scaffold.py``: 64 keyframes, 1200 features a
    keyframe, 2400 map points, the tail 0.3/-0.1/0.2 m from keyframe 0, the
    32k-word vocabulary), each on a fresh map, held to the JAX run
    (``tests/fixtures/loop_correction_full.json``); then one more under
    ``torch.profiler`` for the kernel launches of a correction.  Returns
    (launch counts of the hand kernels, measurements)."""
    import base64

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.optim.gba import MERGE_RANGE
    from orb_slam3_noted_tpu_torch.pipeline import loop_closing as LC
    from orb_slam3_noted_tpu_torch.place.pretrained import load_default_vocabulary

    LS = _scaffold()
    full = LS.FULL
    inp = LS.drifted_map_inputs(seed=ref["seed"], baseline=tuple(ref["baseline"]), **full)
    cfg = SlamConfig(camera=Camera(PINHOLE, full["cam"]), width=full["width"],
                     height=full["height"], n_features=full["n_pts"],
                     max_keyframes=full["max_keyframes"], max_map_points=full["max_map_points"])
    vocab, idf = load_default_vocabulary()
    ck.reset_launch_counts()
    runs = []
    for r in range(CORR_RUNS):
        lc, slam, closed, res, steps, stats = one_correction(inp, cfg, vocab, idf, ref, dev)
        runs.append(steps)
        if r == 0:
            first = (lc, slam, closed, res, stats)
    launches = ck.launch_counts()
    # one more under the profiler: its kernel launches, and for each of the
    # package's ranges inside detection and correction its host ms and the
    # device ms of the kernels it launched (the range's host-side row; the
    # profiler also lists each range on the device's timeline)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_correction(inp, cfg, vocab, idf, ref, dev)
    events = prof.key_averages()
    kernels_per_correction = sum(k.count for k in events if k.device_type == DeviceType.CUDA)
    names = (LC.RANSAC_RANGE, LC.REFINE_RANGE, LC.CORRECT_RANGE, LC.POSE_GRAPH_RANGE, MERGE_RANGE)
    ranges = {k.key: {"calls": k.count, "host_ms": round(k.cpu_time_total / 1e3, 3),
                      "device_ms": round(k.device_time_total / 1e3, 3)}
              for k in events if k.key in names and k.device_type == DeviceType.CPU}
    lc, slam, closed, res, stats = first
    f32 = lambda key, shape: np.frombuffer(base64.b64decode(ref[key]), "<f4").reshape(shape)
    n_kf, n2 = full["n_kf"], 2 * full["n_pts"]
    R_ref, t_ref = f32("kf_Rcw", (n_kf, 3, 3)), f32("kf_tcw", (n_kf, 3))
    R_got, t_got = slam.m.kf_Rcw.cpu().numpy(), slam.m.kf_tcw.cpu().numpy()
    err, before = LS.corrected_point_errors(slam.m.mp_pos.cpu().numpy(), inp)
    pts_vs_jax = float(np.abs(slam.m.mp_pos.cpu().numpy()[:n2] - f32("mp_pos", (n2, 3))).max())
    if res is None:
        raise AssertionError(f"loop correction: no loop accepted ({lc.loop_edges})")
    meas = {
        "closed": bool(closed), "loop_edges": lc.loop_edges,
        "refine_s": float(res.s), "refine_inliers": int(res.n_inliers),
        "jax_refine_s": ref["sim3_refine"][0]["s"], "median_point_err_m": float(np.median(err)),
        "median_drift_before_m": float(np.median(before)),
        "points_vs_jax_max_m": pts_vs_jax,
        "pose_t_vs_jax_max_m": float(np.abs(t_got - t_ref).max()),
        "pose_R_vs_jax_max": float(np.abs(R_got - R_ref).max()),
        "sim3_masks_same": [stats["same_mask"], stats["calls"]],
        "kernels_per_correction": int(kernels_per_correction), "ranges": ranges,
        "first": runs[0], "rest": runs[1:],
    }
    log(f"[loop correction] accepted {lc.loop_edges} (JAX {[(a['slot'], a['cand']) for a in ref['accepted']]}); "
        f"refined s {meas['refine_s']:.6f} ({meas['refine_inliers']} inliers; JAX "
        f"{meas['jax_refine_s']:.6f}); "
        f"median corrected point error {meas['median_point_err_m']:.3g} m (drift before "
        f"{meas['median_drift_before_m']:.3f} m, JAX {ref['median_err_m']:.3g}); points vs JAX "
        f"max {pts_vs_jax:.3g} m; keyframe poses vs JAX max t {meas['pose_t_vs_jax_max_m']:.3g} m, "
        f"R {meas['pose_R_vs_jax_max']:.3g}; Sim(3) masks equal {meas['sim3_masks_same']}")
    for k, run in enumerate(runs):
        log(f"[loop correction] {'first' if k == 0 else f'run {k + 1}'}: steps ms "
            f"{json.dumps({a: round(b, 3) for a, b in run.items()})}")
    log(f"[loop correction] under torch.profiler: {kernels_per_correction} kernel launches per "
        f"correction (detection, ladder, pose graph, fuses, GBA, merge); ranges "
        f"{json.dumps(ranges)}; hand kernels {launches}; {smi}")
    if not closed or lc.loop_edges != [(n_kf - 1, 0)]:
        raise AssertionError(f"loop correction: accepted {lc.loop_edges}, expected [({n_kf - 1}, 0)]")
    if abs(meas["refine_s"] - meas["jax_refine_s"]) > CORR_S_TOL:
        raise AssertionError(f"loop correction: s {meas['refine_s']}, JAX {meas['jax_refine_s']}")
    if meas["median_point_err_m"] > CORR_POINT_M:
        raise AssertionError(f"loop correction: median point error {meas['median_point_err_m']} m")
    if meas["pose_t_vs_jax_max_m"] > CORR_POSE_TOL or meas["pose_R_vs_jax_max"] > CORR_POSE_TOL:
        raise AssertionError(f"loop correction: keyframe poses off the JAX run's: {meas}")
    return launches, meas


# ---------------------------------------------------------------------------
# phase 11: visual-inertial SLAM

def b64_array(text: str, dtype: str, shape) -> np.ndarray:
    import base64

    return np.frombuffer(base64.b64decode(text), dtype).reshape(shape).copy()


def si_config(ref: dict):
    """``bench.py``'s stereo-inertial configuration (``cfg_vi``), as the
    fixture stores it."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE

    return SlamConfig(camera=Camera(PINHOLE, CAM_PARAMS), bf=ref["bf"], **ref["config"])


def si_inputs(ref: dict):
    """(camera centres (n, 3), frame times, [(left, right) uint8], the IMU
    chunk of each batch) of ``bench.py``'s stereo-inertial lap: rendered
    from the JAX run's camera poses, with the JAX run's IMU samples (its
    ``synth_imu`` rounds the gyro's finite difference in its own float32
    ``so3.log``)."""
    n = ref["frames"]
    rwc = b64_array(ref["rwc_f32"], "<f4", (n, 3, 3))
    twc = b64_array(ref["twc_f64"], "<f8", (n, 3))
    pairs = [(a, b) for a, b, _ in render([("stereo", R, t) for R, t in zip(rwc, twc)])]
    chunks = [tuple(b64_array(c[k], "<f8", (c["n"], 3) if k != "ts" else (c["n"],))
                    for k in ("acc", "gyr", "ts")) for c in ref["imu"]]
    return twc, [k / ref["config"]["fps"] for k in range(n)], pairs, chunks


class StageClock:
    """Host milliseconds of the stereo-inertial facade's stages over a lap:
    module functions and instance methods wrapped in place (restored by
    ``restore``); the card is not synchronised inside, so a stage's time is
    its host path (enqueue plus any copy it waits for)."""

    def __init__(self):
        self.ms, self.n, self.undo = {}, {}, []

    def wrap(self, owner, attr: str, name: str):
        fn = getattr(owner, attr)
        self.ms[name], self.n[name] = 0.0, 0

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.ms[name] += (time.perf_counter() - t0) * 1e3
                self.n[name] += 1

        setattr(owner, attr, timed)
        self.undo.append((owner, attr, fn))
        return timed

    def restore(self):
        for owner, attr, fn in reversed(self.undo):
            setattr(owner, attr, fn)

    def summary(self) -> dict:
        return {k: {"n": self.n[k], "host_ms": round(self.ms[k], 3)} for k in self.ms}


def run_si_lap(ref: dict, inputs, dev, smi) -> tuple[dict, dict]:
    """``bench.py``'s stereo-inertial lap (``bench.py:146-212``):
    ``StereoInertialSLAM.process_batch`` in batches of 16 from frame 0 with
    each batch's IMU chunk, loop closing on, ``flush()`` at the end, frames
    staged on the card once; ``inputs`` from :func:`si_inputs`.  Held to
    the JAX run (``SI_*``).  Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline import inertial_system as IS
    from orb_slam3_noted_tpu_torch.pipeline import loop_closing as LC
    from orb_slam3_noted_tpu_torch.pipeline import tracking as T
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    twc, times, pairs, chunks = inputs
    n = len(pairs)
    staged = torch.from_numpy(np.stack([p[0] for p in pairs] + [p[1] for p in pairs])).to(dev)
    frames = [(staged[i], staged[n + i]) for i in range(n)]
    slam = IS.StereoInertialSLAM(si_config(ref), device=dev)
    clock = StageClock()
    clock.wrap(T, "stereo_frontend_batch", "vi_frontend_batch")
    clock.wrap(IS, "vi_track_batch", "vi_track_batch")
    clock.wrap(T, "insert_keyframe_step", "insert_keyframe")
    clock.wrap(slam, "_chain_ba", "chain_ba")
    clock.wrap(LC.LoopCloser, "finish_detect_many", "loop_drain")
    inits = []
    solve = IS.inertial_init

    def recording_init(*args, **kw):
        res = solve(*args, **kw)
        inits.append({"stage": slam.imu_stage, "scale": float(res.scale),
                      "g_world": res.g_world.cpu().numpy().astype(float).tolist()})
        return res

    IS.inertial_init = recording_init
    clock.undo.append((IS, "inertial_init", solve))
    clock.wrap(slam, "_try_imu_init", "imu_init")
    count = DispatchCounter(slam, ("process",))
    stage_frame, walls = {}, []
    try:
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, s0 in enumerate(range(0, n, BATCH)):
            s1 = min(s0 + BATCH, n)
            a, g, ts = chunks[c]
            tb = time.perf_counter()
            slam.process_batch(frames[s0:s1], list(range(s0, s1)), ts=times[s0:s1], acc=a, gyr=g,
                               imu_t=ts)
            walls.append(time.perf_counter() - tb)
            stage_frame.setdefault(str(slam.imu_stage), s1 - 1)
        slam.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ck.launch_counts()
    finally:
        clock.restore()
    states = [r.state for r in slam.trajectory]
    est = slam.positions()
    if len(states) != n or not np.all(np.isfinite(est)):
        raise AssertionError(f"si lap: {len(states)} records for {n} frames, or not finite")
    ok = np.asarray([st == "OK" for st in states])
    ate_se3 = ate_rmse(est[ok], twc[ok], with_scale=False)[0]
    ate_sim3, _, (_, _, scale) = ate_rmse(est[ok], twc[ok], with_scale=True)
    lat = np.asarray(walls) * 1e3
    dispatches = clock.n["vi_frontend_batch"] + count.n["process"]
    stages = clock.summary()
    meas = {
        "tracked": int(ok.sum()), "imu_stage": slam.imu_stage, "stage_frame": stage_frame,
        "inertial_init": inits, "ate_se3_m": float(ate_se3), "ate_sim3_m": float(ate_sim3),
        "ate_sim3_scale": float(scale), "n_kf": slam.n_kf, "kf_inserted": slam.kf_inserted,
        "n_mp": slam.n_mp, "loops_closed": slam.loop_closer.loops_closed if slam.loop_closer else 0,
        "bias_bg": slam.bias.bg.cpu().numpy().astype(float).tolist(),
        "bias_ba": slam.bias.ba.cpu().numpy().astype(float).tolist(),
        "fps": n / wall, "wall_s": wall, "batch_ms_p50": float(np.median(lat)),
        "batch_ms_max": float(lat.max()), "batch_ms": [round(x, 2) for x in lat.tolist()],
        "stages": stages, "dispatches": dispatches, "card": smi,
    }
    log(f"[si] tracked {meas['tracked']}/{n} (JAX {ref['tracked']}), imu_stage {slam.imu_stage} "
        f"(JAX {ref['imu_stage']}), stages reached {stage_frame} (JAX {ref['stage_frame']}), "
        f"ATE SE(3) {ate_se3 * 1e3:.2f} mm (JAX {ref['ate_se3_m'] * 1e3:.2f}), Sim(3) "
        f"{ate_sim3 * 1e3:.2f} mm at scale {scale:.4f} (JAX {ref['ate_sim3_scale']:.4f}), "
        f"keyframe insertions {slam.kf_inserted} (JAX {ref['kf_inserted']}), map points "
        f"{slam.n_mp} (JAX {ref['n_mp']}), loops {meas['loops_closed']} "
        f"(JAX {ref['loops_closed']})")
    log(f"[si] biases bg {meas['bias_bg']} ba {meas['bias_ba']} (JAX bg {ref['bias_bg']} "
        f"ba {ref['bias_ba']})")
    log(f"[si] {meas['fps']:.2f} frames/s over {n} frames ({wall:.2f} s), batch latency p50 "
        f"{meas['batch_ms_p50']:.1f} ms, max {meas['batch_ms_max']:.1f} ms; host ms by stage "
        f"{json.dumps(stages)}; {smi}")
    log(f"[si] launches {launches}; extraction dispatches {dispatches}")
    want = {"fast_candidates": dispatches, "gaussian_blur7": dispatches,
            "brief_sample": dispatches, "sad_stereo": dispatches, "fast_score": 0}
    if launches != want:
        raise AssertionError(f"si lap: launch counts {launches}, expected {want}")
    check_si_lap(meas, ref)
    return launches, meas


def _angle_deg(a, b) -> float:
    a, b = (np.asarray(x, np.float64) / np.linalg.norm(x) for x in (a, b))
    return float(np.degrees(2 * np.arcsin(min(np.linalg.norm(a - b) / 2, 1.0))))


def check_si_lap(got: dict, ref: dict) -> None:
    """The stereo-inertial lap against the JAX run's (``SI_*`` limits)."""
    if got["tracked"] < ref["tracked"] - SI_TRACKED_MARGIN:
        raise AssertionError(f"si lap: tracked {got['tracked']} < {ref['tracked']} - "
                             f"{SI_TRACKED_MARGIN}")
    if got["imu_stage"] != ref["imu_stage"]:
        raise AssertionError(f"si lap: imu_stage {got['imu_stage']}, JAX {ref['imu_stage']}")
    for stage, frame in ref["stage_frame"].items():
        mine = got["stage_frame"].get(stage)
        if mine is None or abs(mine - frame) > SI_STAGE_FRAMES:
            raise AssertionError(f"si lap: stage {stage} reached after frame {mine}, JAX {frame}")
    ate_max = 2.0 * ref["ate_se3_m"] + 0.002
    if got["ate_se3_m"] > ate_max:
        raise AssertionError(f"si lap: SE(3) ATE {got['ate_se3_m']:.5f} m > {ate_max:.5f} m")
    if abs(got["ate_sim3_scale"] - ref["ate_sim3_scale"]) > SI_SCALE_TOL:
        raise AssertionError(f"si lap: Sim(3) scale {got['ate_sim3_scale']:.4f}, JAX "
                             f"{ref['ate_sim3_scale']:.4f}")
    g_deg = _angle_deg(got["inertial_init"][0]["g_world"], ref["inertial_init"][0]["g_world"])
    got["gravity_deg_vs_jax"] = g_deg
    if g_deg > SI_GRAVITY_DEG:
        raise AssertionError(f"si lap: first IMU init's gravity {g_deg:.3f} deg off the JAX run's")
    if abs(got["kf_inserted"] - ref["kf_inserted"]) > SI_KF_MARGIN:
        raise AssertionError(f"si lap: {got['kf_inserted']} keyframe insertions, JAX "
                             f"{ref['kf_inserted']}")
    if got["loops_closed"] != ref["loops_closed"]:
        raise AssertionError(f"si lap: {got['loops_closed']} loops, JAX {ref['loops_closed']}")


def si_metric_line(meas: dict) -> dict:
    """``bench.py``'s stereo-inertial line for the port (this first pass:
    the kernels' and solvers' first calls included)."""
    return {"metric": "stereo_inertial_tracked_fps_752x480_1200feat",
            "value": round(meas["fps"], 2), "unit": "frames/s",
            "vs_baseline": round(meas["fps"] / 20.0, 3), "tracked_frames": meas["tracked"],
            "n_frames": SI_FRAMES, "imu_stage": meas["imu_stage"], "pass": "first",
            "card": meas["card"]}


def run_4dof(ref: dict, dev, smi) -> tuple[dict, dict]:
    """One 4-DoF loop correction at full width: the drifted 64-keyframe map
    of ``scripts/loop_scaffold.py`` with the essential graph of an inertial
    map (``inertial_loop_graph``) through ``optimize_pose_graph_4dof`` on the
    card, held to the JAX run (``FOURDOF_*``); ms per call, the first apart.
    Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.optim.pose_graph import SE3Edges, optimize_pose_graph_4dof

    LS = _scaffold()
    inp = LS.drifted_map_inputs(seed=0, baseline=LS.BASELINE, **LS.FULL)
    gr = LS.inertial_loop_graph(inp)
    E = len(gr["i"])
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    edges = SE3Edges(t(gr["i"]), t(gr["j"]), t(gr["eR"]), t(gr["et"]), t(gr["weight"]),
                     torch.ones(E, dtype=torch.bool, device=dev))
    ms = []
    ck.reset_launch_counts()
    for _ in range(1 + FOURDOF_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R, tt, cost = optimize_pose_graph_4dof(t(gr["R"]), t(gr["t"]), edges, t(gr["fixed"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = ck.launch_counts()
    K = ref["n_kf"]
    Rj = b64_array(ref["kf_Rcw"], "<f4", (K, 3, 3))
    tj = b64_array(ref["kf_tcw"], "<f4", (K, 3))
    Rn, tn = R.cpu().numpy(), tt.cpu().numpy()
    up_new, up_old = Rn[:, :, 2], gr["R"][:, :, 2]
    tilt = 2 * np.arcsin(np.clip(np.linalg.norm(up_new - up_old, axis=1) / 2, 0, 1))
    meas = {"n_kf": K, "n_edges": E, "cost": float(cost), "jax_cost": ref["cost"],
            "pose_R_vs_jax_max": float(np.abs(Rn - Rj).max()),
            "pose_t_vs_jax_max_m": float(np.abs(tn - tj).max()),
            "tilt_max_rad": float(tilt.max()), "tail_moved_m": float(np.abs(tn - gr["t"]).max()),
            "first_ms": ms[0], "ms": float(np.median(ms[1:])), "card": smi}
    log(f"[4dof] {K} keyframes, {E} edges: cost {meas['cost']:.6f} (JAX {ref['cost']:.6f}), "
        f"|dR| vs JAX {meas['pose_R_vs_jax_max']:.2e}, |dt| vs JAX "
        f"{meas['pose_t_vs_jax_max_m']:.2e} m, largest roll/pitch change "
        f"{meas['tilt_max_rad']:.2e} rad; {ms[0]:.1f} ms the first call, "
        f"{meas['ms']:.1f} ms after; {smi}")
    if meas["pose_R_vs_jax_max"] > FOURDOF_TOL or meas["pose_t_vs_jax_max_m"] > FOURDOF_TOL:
        raise AssertionError(f"4dof: poses off the JAX run's: {meas}")
    if meas["tilt_max_rad"] > FOURDOF_TILT:
        raise AssertionError(f"4dof: a keyframe's gravity direction moved {meas['tilt_max_rad']}")
    if meas["tail_moved_m"] < 0.05:
        raise AssertionError("4dof: the graph did not move the drifted tail")
    return launches, meas


# ---------------------------------------------------------------------------
# phase 12: fisheye stereo (TUM-VI 512x512)

def fisheye_config(ref: dict):
    """The TUM-VI fisheye configuration as the fixture stores it: TUM_512's
    two Kannala-Brandt cameras, the rotated right camera, 1500 features."""
    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, KANNALA_BRANDT8

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in ref["config"].items()}
    return SlamConfig(camera=Camera(KANNALA_BRANDT8, tuple(ref["camera1"])),
                      camera2=Camera(KANNALA_BRANDT8, tuple(ref["camera2"])), **kw)


_FE_ROOM = []


def _render_fisheye_job(job):
    """One fisheye pair: the left image through camera 1 at (Rwc, twc), the
    right through camera 2 at (Rwc Rlr, twc + Rwc tlr), uint8; with
    ``depth`` also the left image's depth map (float32)."""
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, KANNALA_BRANDT8
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom

    room, cam1, cam2, Rlr, tlr, Rwc, twc, depth = job
    if not _FE_ROOM:
        import torch

        torch.set_num_threads(1)  # one of a pool of processes, one a core
        _FE_ROOM.append(BoxRoom(**room))
    Rwc = np.asarray(Rwc, np.float64)
    left = _FE_ROOM[0].render_fisheye(Rwc, twc, Camera(KANNALA_BRANDT8, cam1), FE_W, FE_H,
                                      return_depth=depth)
    right = _FE_ROOM[0].render_fisheye(Rwc @ np.asarray(Rlr, np.float64),
                                       twc + Rwc @ np.asarray(tlr, np.float64),
                                       Camera(KANNALA_BRANDT8, cam2), FE_W, FE_H)
    if depth:
        left, dmap = left
        return left.astype(np.uint8), right.astype(np.uint8), dmap.astype(np.float32)
    return left.astype(np.uint8), right.astype(np.uint8)


def fisheye_inputs(ref: dict):
    """(camera centres (n, 3), [(left, right) uint8], frame 0's depth map) of
    the fisheye lap, rendered by the port's KB8 ``render_fisheye`` from the
    JAX run's camera poses (the worker pool)."""
    n = ref["frames"]
    rwc = b64_array(ref["rwc_f32"], "<f4", (n, 3, 3))
    twc = b64_array(ref["twc_f64"], "<f8", (n, 3))
    cfg = ref["config"]
    Rlr = np.asarray(cfg["tlr_r"], np.float32).reshape(3, 3)
    jobs = [(ref["room"], tuple(ref["camera1"]), tuple(ref["camera2"]), Rlr, cfg["tlr_t"],
             rwc[k], twc[k], k == 0) for k in range(n)]
    out = pool_map(_render_fisheye_job, jobs)
    depth0 = out[0][2]
    return twc, [o[:2] for o in out], depth0


def fisheye_frame0(calls: list, depth0) -> dict:
    """Frame 0's fisheye stereo as the facade ran it (the first recorded
    ``match_fisheye_stereo`` call): valid matches, and the median relative
    error of their depths against the rendered depth map."""
    xy, sm = calls[0]
    v = sm.valid.cpu().numpy()
    xy = xy.cpu().numpy()[v]
    d = sm.depth.cpu().numpy()[v]
    gt = depth0[np.clip(np.round(xy[:, 1]).astype(int), 0, FE_H - 1),
                np.clip(np.round(xy[:, 0]).astype(int), 0, FE_W - 1)]
    return {"matches": int(v.sum()), "depth_rel_median": float(np.median(np.abs(d - gt) / gt)),
            "idx_r": sm.idx_r.cpu().numpy()}


class RecordFirstMatches:
    """Records the facade's first ``match_fisheye_stereo`` call (the left
    features' xy and the result) while in place in ``pipeline.tracking``
    (``fisheye_stereo_rows``)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from orb_slam3_noted_tpu_torch.pipeline import tracking

        self.orig = tracking.match_fisheye_stereo

        def recording(feats_l, *args, **kw):
            out = self.orig(feats_l, *args, **kw)
            if not self.calls:
                self.calls.append((feats_l.xy.clone(), out))
            return out

        tracking.match_fisheye_stereo = recording
        return self

    def __exit__(self, *exc):
        from orb_slam3_noted_tpu_torch.pipeline import tracking

        tracking.match_fisheye_stereo = self.orig


def fisheye_ate(est, twc, ok) -> tuple[float, float]:
    """(RMS error with the first pose's offset removed, as
    tests/test_fisheye_stereo.py:102-106 does, over the tracked frames; RMS
    error after SE(3) alignment)."""
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    err0 = np.linalg.norm((est - est[0]) - (twc - twc[0]), axis=1)
    return (float(np.sqrt(np.mean(err0[ok] ** 2))),
            float(ate_rmse(est[ok], twc[ok], with_scale=False)[0]))


def split_by_range(prof, ranges: tuple, n_frames: int) -> dict:
    """Per frame and per facade range (and ``rest`` for what lies outside
    them): kernel launches (``cudaLaunchKernel*`` calls), host-to-device
    copies (operations whose linked device record is a ``Memcpy HtoD``,
    listed by the chain of operations that issued them) and device-to-host
    ones (``Memcpy DtoH``: every read of a result on the host), all placed by
    the host time of the call, and the host time of the range itself."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = {r: sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.name == r and e.device_type == DeviceType.CPU) for r in ranges}

    def where(t):
        for r, ivs in spans.items():
            if any(a <= t <= b for a, b in ivs):
                return r
        return "rest"

    out = {r: {"launches": 0, "h2d_copies": 0, "d2h_copies": 0, "h2d_from": {},
               "host_ms": sum(b - a for a, b in spans.get(r, ())) / 1e3 / n_frames}
           for r in (*ranges, "rest")}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cudaLaunchKernel"):
            out[where(e.time_range.start)]["launches"] += 1
        elif (e.device_type == DeviceType.CPU
              and any(k.name.startswith("Memcpy HtoD") for k in e.kernels)):
            r = out[where(e.time_range.start)]
            r["h2d_copies"] += 1
            chain, up = [], e
            while up is not None and len(chain) < 4:
                chain.append(up.name)
                up = up.cpu_parent
            r["h2d_from"][" < ".join(chain)] = r["h2d_from"].get(" < ".join(chain), 0) + 1
        if (e.device_type == DeviceType.CPU
                and any(k.name.startswith("Memcpy DtoH") for k in e.kernels)):
            out[where(e.time_range.start)]["d2h_copies"] += 1
    for r in out.values():
        r["launches"] /= n_frames
        r["h2d_copies"] /= n_frames
        r["d2h_copies"] /= n_frames
        r["h2d_from"] = {k: v / n_frames for k, v in r["h2d_from"].items()}
    return out


def profile_fisheye_stages(make, frames, dev, start: int, stop: int) -> dict:
    """Kernel launches and host ms a frame by the facade's ranges (ORB
    extraction, fisheye stereo matching, the keyframe mapper, the rest:
    tracking), from ``torch.profiler`` over frames [start, stop) of a fresh
    facade; ``make()`` builds it, ``frames`` are (left, right, kwargs)."""
    import torch

    from orb_slam3_noted_tpu_torch.pipeline import system

    slam = make()
    ranges = (system.EXTRACTION_RANGE, system.STEREO_RANGE, system.KEYFRAME_RANGE)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    for i, (left, right, kw) in enumerate(frames[:stop]):
        if i == start:
            torch.cuda.synchronize()
            prof.__enter__()
            t0 = time.perf_counter()
            kf0 = slam.kf_inserted
        slam.process(left, right, i, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.__exit__(None, None, None)
    n = stop - start
    out = split_by_range(prof, ranges, n)
    out["rest"]["host_ms"] = wall_ms / n - sum(v["host_ms"] for k, v in out.items()
                                              if k != "rest")
    return {"frames": [start, stop],
            "launches_per_frame": sum(v["launches"] for v in out.values()),
            "by_stage": out, "kf_inserted_in_window": slam.kf_inserted - kf0}


def run_fisheye_lap(ref: dict, inputs, dev, smi) -> tuple[dict, dict]:
    """12a: ``FisheyeStereoSLAM.process`` over the 100 pairs, loop closing
    off, held to the JAX run (``FE_*``); K1-K3 once a frame, K4 never; then
    launches and host ms a frame by stage over a profiled window of a
    second run.  Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import FisheyeStereoSLAM

    twc, pairs, depth0 = inputs
    n = len(pairs)
    cfg = fisheye_config(ref)
    staged = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for a, b in pairs]
    slam = FisheyeStereoSLAM(cfg, device=dev)
    n_mp_init = None
    with RecordFirstMatches() as rec:
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (left, right) in enumerate(staged):
            slam.process(left, right, i)
            if n_mp_init is None and slam.state == "OK":
                n_mp_init = slam.n_mp
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ck.launch_counts()
    est = slam.positions()
    states = [r.state for r in slam.trajectory]
    if len(states) != n or not np.all(np.isfinite(est)):
        raise AssertionError(f"fisheye lap: {len(states)} records for {n} frames, or not finite")
    ok = np.asarray([s == "OK" for s in states])
    ate0, ate_se3 = fisheye_ate(est, twc, ok)
    f0 = fisheye_frame0(rec.calls, depth0)
    same_idx = float(np.mean(f0["idx_r"] == np.asarray(ref["frame0_idx_r"])))
    meas = {"tracked": int(ok.sum()), "n_kf": slam.n_kf, "kf_inserted": slam.kf_inserted,
            "n_mp": slam.n_mp, "n_mp_init": n_mp_init, "frame0_matches": f0["matches"],
            "frame0_depth_rel_median": f0["depth_rel_median"], "frame0_idx_r_same": same_idx,
            "ate_origin_rmse_m": ate0, "ate_se3_m": ate_se3,
            "pos_vs_jax_max_m": float(np.abs(est - np.asarray(ref["positions"])).max()),
            "kf_xy_r_rows": kf_xy_r_rows(slam), "fps": n / wall, "wall_s": wall, "card": smi}
    log(f"[fisheye] tracked {meas['tracked']}/{n} (JAX {ref['tracked']}), keyframes "
        f"{slam.n_kf} (JAX {ref['n_kf']}), insertions {slam.kf_inserted} (JAX "
        f"{ref['kf_inserted']}), initial map {n_mp_init} (JAX {ref['n_mp_init']}), map points "
        f"{slam.n_mp} (JAX {ref['n_mp']}); ATE with the first pose's offset removed "
        f"{ate0 * 1e3:.2f} mm (JAX {ref['ate_origin_rmse_m'] * 1e3:.2f}), after SE(3) "
        f"alignment {ate_se3 * 1e3:.2f} mm (JAX {ref['ate_se3_m'] * 1e3:.2f})")
    log(f"[fisheye] frame 0: {f0['matches']} fisheye stereo matches (JAX "
        f"{ref['frame0_matches']}), the same right feature for {same_idx:.4f} of the left "
        f"ones, median relative depth error {f0['depth_rel_median']:.4f} (JAX "
        f"{ref['frame0_depth_rel_median']:.4f})")
    log(f"[fisheye] {meas['fps']:.2f} frames/s over {n} frames ({wall:.2f} s); launches "
        f"{launches}; {smi}")
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"fisheye lap: launch counts {launches}, expected {want}")
    if meas["tracked"] < ref["tracked"] - FE_TRACKED_MARGIN:
        raise AssertionError(f"fisheye lap: tracked {meas['tracked']}, JAX {ref['tracked']}")
    ate_max = 2.0 * ref["ate_origin_rmse_m"] + 0.002
    if ate0 > ate_max:
        raise AssertionError(f"fisheye lap: ATE {ate0:.5f} m > {ate_max:.5f} m")
    if abs(slam.n_kf - ref["n_kf"]) > FE_KF_MARGIN:
        raise AssertionError(f"fisheye lap: {slam.n_kf} keyframes, JAX {ref['n_kf']}")
    if n_mp_init is None or abs(n_mp_init - ref["n_mp_init"]) > FE_RTOL * ref["n_mp_init"]:
        raise AssertionError(f"fisheye lap: initial map {n_mp_init}, JAX {ref['n_mp_init']}")
    if abs(f0["matches"] - ref["frame0_matches"]) > FE_RTOL * ref["frame0_matches"]:
        raise AssertionError(f"fisheye lap: frame 0 matches {f0['matches']}, JAX "
                             f"{ref['frame0_matches']}")
    meas["profile"] = profile_fisheye_stages(
        lambda: FisheyeStereoSLAM(cfg, device=dev), [(a, b, {}) for a, b in staged], dev,
        *FE_PROFILE_FRAMES)
    log(f"[fisheye] launches and host ms a frame by stage, frames {FE_PROFILE_FRAMES}: "
        f"{json.dumps(meas['profile'])}")
    return launches, meas


def run_fisheye_vi_lap(ref: dict, inputs, dev, smi) -> tuple[dict, dict]:
    """12b: ``FisheyeStereoInertialSLAM.process`` over the same pairs with
    the JAX run's 200 Hz IMU samples, held to the JAX run (``FE_*``); K1-K3
    once a frame; host ms by stage.  Then the first ``FE_BATCH_FRAMES``
    frames once through ``process_batch`` on a fresh facade: the same
    trajectory records.  Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline import inertial_system as IS
    from orb_slam3_noted_tpu_torch.pipeline import tracking as T
    from orb_slam3_noted_tpu_torch.pipeline.system import FisheyeStereoSLAM

    twc, pairs, _ = inputs
    n = len(pairs)
    cfg = fisheye_config(ref)
    times = [k / cfg.fps for k in range(n)]
    chunks = [tuple(b64_array(c[k], "<f8", (c["n"], 3) if k != "ts" else (c["n"],))
                    for k in ("acc", "gyr", "ts")) for c in ref["imu"]]
    staged = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for a, b in pairs]
    slam = IS.FisheyeStereoInertialSLAM(cfg, device=dev)
    clock = StageClock()
    clock.wrap(FisheyeStereoSLAM, "_fisheye_frontend", "fisheye_frontend")
    clock.wrap(slam, "_track", "track_visual")
    clock.wrap(slam, "_track_inertial", "track_inertial")
    clock.wrap(T, "insert_keyframe_step", "insert_keyframe")
    clock.wrap(slam, "_chain_ba", "chain_ba")
    inits, solve = [], IS.inertial_init

    def recording_init(*args, **kw):
        res = solve(*args, **kw)
        inits.append({"stage": slam.imu_stage, "g_world": res.g_world.cpu().numpy().astype(
            float).tolist()})
        return res

    IS.inertial_init = recording_init
    clock.undo.append((IS, "inertial_init", solve))
    clock.wrap(slam, "_try_imu_init", "imu_init")
    stage_frame = {}
    try:
        ck.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, (left, right) in enumerate(staged):
            a, g, ts = chunks[i]
            slam.process(left, right, i, t=times[i], acc=a, gyr=g, imu_t=ts)
            stage_frame.setdefault(str(slam.imu_stage), i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ck.launch_counts()
    finally:
        clock.restore()
    est = slam.positions()
    states = [r.state for r in slam.trajectory]
    if len(states) != n or not np.all(np.isfinite(est)):
        raise AssertionError(f"fisheye VI lap: {len(states)} records for {n} frames")
    ok = np.asarray([s == "OK" for s in states])
    ate0, ate_se3 = fisheye_ate(est, twc, ok)
    meas = {"tracked": int(ok.sum()), "imu_stage": slam.imu_stage, "stage_frame": stage_frame,
            "inertial_init": inits, "ate_se3_m": ate_se3, "ate_origin_rmse_m": ate0,
            "n_kf": slam.n_kf, "kf_inserted": slam.kf_inserted, "n_mp": slam.n_mp,
            "fps": n / wall, "wall_s": wall, "stages": clock.summary(), "card": smi}
    log(f"[fisheye-vi] tracked {meas['tracked']}/{n} (JAX {ref['tracked']}), imu_stage "
        f"{slam.imu_stage} (JAX {ref['imu_stage']}), stages reached {stage_frame} (JAX "
        f"{ref['stage_frame']}), ATE SE(3) {ate_se3 * 1e3:.2f} mm (JAX "
        f"{ref['ate_se3_m'] * 1e3:.2f}), with the first pose's offset removed "
        f"{ate0 * 1e3:.2f} mm (JAX {ref['ate_origin_rmse_m'] * 1e3:.2f}), insertions "
        f"{slam.kf_inserted} (JAX {ref['kf_inserted']}), map points {slam.n_mp} (JAX "
        f"{ref['n_mp']})")
    log(f"[fisheye-vi] {meas['fps']:.2f} frames/s over {n} frames ({wall:.2f} s); host ms by "
        f"stage {json.dumps(meas['stages'])}; launches {launches}; {smi}")
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"fisheye VI lap: launch counts {launches}, expected {want}")
    if meas["tracked"] < ref["tracked"] - FE_TRACKED_MARGIN:
        raise AssertionError(f"fisheye VI lap: tracked {meas['tracked']}, JAX {ref['tracked']}")
    if slam.imu_stage != ref["imu_stage"]:
        raise AssertionError(f"fisheye VI lap: imu_stage {slam.imu_stage}, JAX "
                             f"{ref['imu_stage']}")
    for stage, frame in ref["stage_frame"].items():
        mine = stage_frame.get(stage)
        if mine is None or abs(mine - frame) > FE_STAGE_FRAMES:
            raise AssertionError(f"fisheye VI lap: stage {stage} at frame {mine}, JAX {frame}")
    g_deg = _angle_deg(inits[0]["g_world"], ref["inertial_init"][0]["g_world"])
    meas["gravity_deg_vs_jax"] = g_deg
    if g_deg > FE_GRAVITY_DEG:
        raise AssertionError(f"fisheye VI lap: first IMU init's gravity {g_deg:.3f} deg off")
    ate_max = 2.0 * ref["ate_se3_m"] + 0.002
    if ate_se3 > ate_max:
        raise AssertionError(f"fisheye VI lap: SE(3) ATE {ate_se3:.5f} m > {ate_max:.5f} m")
    if abs(slam.kf_inserted - ref["kf_inserted"]) > FE_VI_KF_MARGIN:
        raise AssertionError(f"fisheye VI lap: {slam.kf_inserted} insertions, JAX "
                             f"{ref['kf_inserted']}")

    # process_batch is a loop over process: the first frames once through it
    nb = FE_BATCH_FRAMES
    batch = IS.FisheyeStereoInertialSLAM(cfg, device=dev)
    acc, gyr, ts = (np.concatenate([c[k] for c in chunks[:nb]]) for k in range(3))
    batch.process_batch(staged[:nb], list(range(nb)), ts=times[:nb], acc=acc, gyr=gyr, imu_t=ts)
    diff = max(max(float(np.abs(a.Rcw - b.Rcw).max()), float(np.abs(a.tcw - b.tcw).max()))
               for a, b in zip(batch.trajectory, slam.trajectory[:nb]))
    same_states = [r.state for r in batch.trajectory] == states[:nb]
    meas["batch_vs_process_max_diff"] = diff
    log(f"[fisheye-vi] process_batch over frames 0-{nb - 1}: {len(batch.trajectory)} records, "
        f"states {'equal' if same_states else 'differ'}, largest pose difference against "
        f"process {diff:.3g}")
    if len(batch.trajectory) != nb or not same_states or diff > 0.0:
        raise AssertionError("fisheye VI lap: process_batch's trajectory differs from process's")
    return launches, meas


def check_fisheye_kernels(ref: dict, pair, dev) -> dict:
    """12c: K1, K2 and K3 over the (2, HA, 512) atlas of frame 0's fisheye
    pair against their plain versions (K1 and K3 exact, K2 within
    ``K2_ATOL``), each timed three ways beside its bound; K2 also beside
    reflect pad + two ``conv2d`` per level and image.  Keys end in
    ``_fisheye_pair``."""
    import torch
    import torch.nn.functional as F

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import image as image_ops

    cfg = fisheye_config(ref)
    pyr, atlas = pair_atlas(cfg, pair[0], pair[1], dev)
    res = check_extraction_batch(cfg, pyr, atlas, "fisheye_pair")
    taps = torch.from_numpy(image_ops.gaussian_kernel1d(7, ck.BLUR_SIGMA)).to(dev)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the yardstick computes in float32 too

    def blur_library():
        return [F.conv2d(F.conv2d(F.pad(lv[:, None], (3, 3, 3, 3), mode="reflect"),
                                  taps.view(1, 1, 1, 7)), taps.view(1, 1, 7, 1))[:, 0]
                for lv in pyr]

    plain = image_ops.level_views(ck.gaussian_blur7_plain(atlas.image, atlas.sizes), atlas.sizes)
    for lib, ref_ in zip(blur_library(), plain):
        if float((lib - ref_).abs().max()) > 1e-3:
            raise AssertionError("the library blur computes another function")
    res["gaussian_blur7"].update({f"{k}_fisheye_pair": v for k, v in
                                  reference_times(blur_library, "library").items()})
    torch.backends.cudnn.allow_tf32 = tf32
    return res


# ---------------------------------------------------------------------------
# phase 13: the Atlas


def atlas_two_view_draws(ref: dict, own):
    """A stand-in for ``MonoSLAM._minimal_sets`` on a frame-by-frame lap:
    the JAX run's two-view sets for the frame (seed) where its match mask
    equals the port's, else the port's own draw (``own``); ``stats`` counts
    both."""
    import base64

    import torch

    by_seed = {}
    for d in ref["init_draws"]:
        mask = np.unpackbits(np.frombuffer(base64.b64decode(d["matched"]), np.uint8),
                             count=d["n"]).astype(bool)
        sets = np.frombuffer(base64.b64decode(d["sets"]), "<i2").reshape(d["shape"])
        by_seed.setdefault(d["seed"], []).append((mask, sets))
    stats = {"calls": 0, "jax_draws": 0}

    def draws(valid, seed, slam):
        stats["calls"] += 1
        v = valid.cpu().numpy()
        for mask, sets in by_seed.get(int(seed), ()):
            if np.array_equal(mask, v):
                stats["jax_draws"] += 1
                return torch.from_numpy(sets.astype(np.int64)).to(valid.device)
        return own(valid, seed, slam)

    draws.stats = stats
    return draws


def drawn_class(base, ref: dict):
    """``base`` with its two-view draws taken from the JAX run (every map
    the Atlas starts is an instance of it)."""

    class Drawn(base):
        def _minimal_sets(self, valid, seed):
            return Drawn.draws(valid, seed, self)

    Drawn.draws = atlas_two_view_draws(ref, lambda v, s, slam: base._minimal_sets(slam, v, s))
    return Drawn


class MergeWatch:
    """Wraps an Atlas's ``_do_merge`` and ``_merge_sets``: the merge's RANSAC
    sets are the JAX run's for the same slot and pair mask (else the port's
    own), and each merge is timed with the card synchronised, its kernel
    launches counted under ``torch.profiler``, and its slot, candidate,
    inliers and world transform kept."""

    def __init__(self, atlas, ref: dict, frame):
        self.merges, self.frame, self.atlas = [], frame, atlas
        self._sets = fixture_sim3_draws(ref["merge_attempts"], atlas._merge_sets)
        atlas._merge_sets = self._sets
        self._do, self._transform = atlas._do_merge, atlas._merge_transform
        atlas._do_merge = self._do_merge
        atlas._merge_transform = self._keep_transform
        self._S = None

    def _keep_transform(self, st, slot, cand, res):
        S = self._transform(st, slot, cand, res)
        self._S = S
        return S

    def _do_merge(self, st, si, slot, cand, res):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        n_in = int(res.n_inliers)
        self.kf0_frames = (int(st.m.kf_frame_id[0]), int(self.atlas.active.m.kf_frame_id[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ok = self._do(st, si, slot, cand, res)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if ok:
            kernels = sum(k.count for k in prof.key_averages() if k.device_type == DeviceType.CUDA)
            R, t, s_ = (x.detach().cpu().numpy().astype(np.float64) for x in self._S)
            self.merges.append({"frame_id": self.frame(), "slot": int(slot), "cand": int(cand),
                                "kf_off": int(st.n_kf), "n_inliers": n_in,
                                "ms_profiled": round(ms, 3), "kernel_launches": int(kernels),
                                "R": R, "t": t, "s": float(s_)})
        return ok


def atlas_schedule_frames(ref: dict, kind: str):
    """The lap's images by frame: ``kind`` render jobs for the fixture's
    poses (the JAX run's camera rotations), zeros for the blank frames."""
    rwc = b64_array(ref["rwc_f32"], "<f4", (-1, 3, 3))
    if "twc_f64" in ref:
        twc = b64_array(ref["twc_f64"], "<f8", (-1, 3))
        poses = list(zip(rwc, twc))
        keys = list(range(len(ref["frame_ids"])))
    else:
        from orb_slam3_noted_tpu_torch.utils.synthetic import orbit_trajectory

        traj = orbit_trajectory(len(rwc), forward=0.03, yaw0=0.45)
        poses = [(R.copy(), t) for R, (_, t) in zip(rwc, traj)]
        keys = ref["pose_index"]
    need = sorted({k for k, pi in zip(keys, ref["pose_index"]) if pi is not None})
    rendered = dict(zip(need, render([(kind, poses[k][0], poses[k][1]) for k in need])))
    return poses, [rendered.get(k) if pi is not None else None
                   for k, pi in zip(keys, ref["pose_index"])]


def check_merge(tag: str, got: list, ref: dict, fid_of, mono: bool = False, truth=None,
                hold_cand: bool = True, jax_S=None, max_deg: float = ATLAS_METRIC_DEG,
                max_t: float | None = ATLAS_METRIC_T_M) -> dict:
    """One merge, near JAX's (frame, candidate unless ``hold_cand`` is
    false, inliers, world transform: JAX's, or ``jax_S`` in its place; a
    metric merge at JAX's scale, within ``max_deg`` and ``max_t`` (None: not
    held); ``truth``: the true relative rotation of the two maps' worlds)."""
    jm, ja = ref["merges"], ref["merge_attempts"]
    if len(got) != 1 or len(jm) != 1:
        raise AssertionError(f"{tag}: merges {[(m['frame_id'], m['slot'], m['cand']) for m in got]}, "
                             f"JAX {[(m['frame_id'], m['slot'], m['cand']) for m in jm]}")
    g, j = got[0], dict(jm[0])
    if jax_S is not None:
        j["R"], j["t"], j["s"] = jax_S
    j_in = next(a["n_inliers"] for a in ja if a["success"] and a["cand"] == j["cand"]
                and a["frame_id"] == j["frame_id"])
    ids = ref["frame_ids"]
    if abs(ids.index(g["frame_id"]) - ids.index(j["frame_id"])) > ATLAS_MERGE_FRAMES:
        raise AssertionError(f"{tag}: merged at frame {g['frame_id']}, JAX at {j['frame_id']}")
    fc_g, fc_j = fid_of(g["cand"]), j["cand_frame"]
    if hold_cand and g["cand"] != j["cand"] and abs(fc_g - fc_j) > ATLAS_CAND_FRAMES:
        raise AssertionError(f"{tag}: merge candidate slot {g['cand']} (frame {fc_g}), JAX "
                             f"{j['cand']} (frame {fc_j})")
    if g["n_inliers"] < 0.5 * j_in:
        raise AssertionError(f"{tag}: merge RANSAC inliers {g['n_inliers']} < half JAX's {j_in}")
    dS = max(float(np.abs(g["R"] - np.asarray(j["R"])).max()),
             float(np.abs(g["t"] - np.asarray(j["t"])).max()), abs(g["s"] - j["s"]))
    deg = rotation_deg(g["R"], np.asarray(j["R"]))
    out = {"frame_id": g["frame_id"], "slot": g["slot"], "cand": g["cand"],
           "cand_frame": fc_g, "n_inliers": g["n_inliers"], "jax": [j["frame_id"], j["slot"], j["cand"], j_in],
           "S_vs_jax_max": dS, "R_vs_jax_deg": deg, "s": g["s"], "jax_s": j["s"],
           "ms": g["ms_profiled"], "kernel_launches": g["kernel_launches"]}
    if truth is not None:
        out["R_vs_truth_deg"] = rotation_deg(g["R"], truth)
        out["jax_R_vs_truth_deg"] = rotation_deg(np.asarray(j["R"]), truth)
    dt = float(np.abs(g["t"] - np.asarray(j["t"])).max())
    out["t_vs_jax_m"] = dt
    if mono:
        if truth is not None:
            far = out["R_vs_truth_deg"] > (ATLAS_MONO_DEG_FACTOR * out["jax_R_vs_truth_deg"]
                                           + ATLAS_MONO_DEG)
        else:
            far = deg > ATLAS_MONO_DEG
        if far or abs(g["s"] / j["s"] - 1) > ATLAS_MONO_SCALE:
            raise AssertionError(f"{tag}: world transform {deg:.3g} deg from JAX's, scale "
                                 f"{g['s']:.4f} against {j['s']:.4f}; {out}")
    elif g["s"] != j["s"] or deg > max_deg or (max_t is not None and dt > max_t):
        raise AssertionError(f"{tag}: world transform {deg:.3g} deg, {dt:.3g} m, scale "
                             f"{g['s']!r} from JAX's ({j['s']!r}); {out}")
    return out


def run_atlas_lap(ref: dict, dev, smi) -> tuple[dict, dict]:
    """13a and 13d.  ``AtlasSLAM(MonoSLAM)`` at ``bench.py``'s monocular
    configuration (loop closing on) frame by frame over the kidnapped Atlas
    lap (``tests/fixtures/atlas_lap.json``) on the JAX run's two-view and
    merge draws; right after the merge a checkpoint of the active system,
    which a fresh ``MonoSLAM`` restores and runs over the next
    ``ATLAS_CKPT_FRAMES`` frames as the original does.  Returns (launch
    counts of the lap, measurements)."""
    import tempfile

    import torch

    from orb_slam3_noted_tpu_torch.io.checkpoint import load_map, save_map
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.ops import orb as O
    from orb_slam3_noted_tpu_torch.pipeline.atlas import AtlasSLAM
    from orb_slam3_noted_tpu_torch.pipeline.system import MonoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    poses, imgs = atlas_schedule_frames(ref, "mono")
    ids, pidx = ref["frame_ids"], ref["pose_index"]
    blank = np.zeros((H, W), np.uint8)
    cfg = mono_config(loop_closing=True)
    Drawn = drawn_class(MonoSLAM, ref)
    atlas = AtlasSLAM(cfg, Drawn, device=dev)
    cur = {"frame": None}
    watch = MergeWatch(atlas, ref, lambda: cur["frame"])
    tmp = tempfile.mkdtemp(prefix="atlas_ckpt_")
    ckpt = os.path.join(tmp, "map.npz")
    ckpt_at = None
    n_kf_a = None
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, fid in enumerate(ids):
        cur["frame"] = fid
        merged = atlas.merges
        atlas.process(imgs[k] if imgs[k] is not None else blank, fid)
        if atlas.stored and n_kf_a is None:
            n_kf_a = atlas.stored[0].n_kf
        if atlas.merges > merged:
            save_map(ckpt, atlas.active)
            ckpt_at = k
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()
    atlas.flush()
    a = atlas.active
    fid_of = lambda s: int(a.m.kf_frame_id[s])  # noqa: E731
    # each map's world is the camera of its first keyframe
    fa, fb = (pidx[ids.index(f)] for f in watch.kf0_frames)
    merge = check_merge("atlas lap", watch.merges, ref, fid_of, mono=True,
                        truth=poses[fa][0].T.astype(np.float64) @ poses[fb][0])

    est = atlas.positions()
    states = [r.state for r in atlas.trajectory]
    ok = np.asarray([s == "OK" and p is not None for s, p in zip(states, pidx)])
    gt = np.asarray([poses[p][1] if p is not None else np.zeros(3) for p in pidx])
    ate, _, (_, _, scale) = ate_rmse(est[ok], gt[ok], with_scale=True)
    tracked = int(sum(s == "OK" for s in states))
    # the merged database retrieves a pre-merge keyframe for frame 2's view
    q_img = torch.from_numpy(imgs[pidx.index(ref["query_pose"])]).to(dev, torch.float32)
    q = O.extract_orb(q_img, n_features=cfg.n_features)
    _, bow = a.loop_closer.db.compute_bow(q.desc, q.valid)
    slots, _ = a.loop_closer.db.detect_candidates(bow, np.zeros(cfg.max_keyframes, bool),
                                                  n_best=3, min_rel_score=0.5)

    # 13d: the checkpoint, restored, against the original over the next frames
    z = np.load(ckpt)
    schema = {k: [str(z[k].dtype), list(z[k].shape)] for k in z.files}
    jschema = ref["checkpoint_schema"]
    fixed = [k for k in jschema if k.startswith("map_") or k in ("last_Rcw", "last_tcw",
                                                                  "kf_frame_ids", "db_vocab",
                                                                  "db_idf")]
    if set(schema) != set(jschema) or any(schema[k][0] != jschema[k][0] for k in jschema) \
            or any(schema[k][1] != jschema[k][1] for k in fixed) \
            or any(schema[k][1][1:] != jschema[k][1][1:] for k in jschema):
        diff = {k: (schema.get(k), jschema.get(k)) for k in set(schema) | set(jschema)
                if schema.get(k) != jschema.get(k)}
        raise AssertionError(f"atlas lap: checkpoint schema differs from the JAX run's: {diff}")
    nxt = list(range(ckpt_at + 1, min(ckpt_at + 1 + ATLAS_CKPT_FRAMES, len(ids))))
    restored = MonoSLAM(cfg, device=dev)
    load_map(ckpt, restored)
    by_fid = {r.frame_id: r for r in atlas.trajectory}
    worst, ck_ms = 0.0, []
    for k in nxt:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = restored.process(imgs[k] if imgs[k] is not None else blank, ids[k])
        torch.cuda.synchronize()
        ck_ms.append((time.perf_counter() - t1) * 1e3)
        o = by_fid[ids[k]]
        worst = max(worst, float(np.abs(r.Rcw - o.Rcw).max()), float(np.abs(r.tcw - o.tcw).max()))
        if (r.state, r.n_inliers) != (o.state, o.n_inliers) or worst > 1e-6:
            raise AssertionError(f"checkpoint: frame {ids[k]} restored {r.state} {r.n_inliers}, "
                                 f"original {o.state} {o.n_inliers}, poses {worst:.3g} apart")
    shutil.rmtree(tmp)

    meas = {"fps": len(ids) / wall, "wall_s": wall, "maps_created": atlas.maps_created,
            "merges": atlas.merges, "merge": merge, "merge_draw_stats": watch._sets.stats,
            "two_view_draw_stats": Drawn.draws.stats, "n_kf_a": n_kf_a, "n_kf": a.n_kf,
            "tracked": tracked, "ate_m": float(ate), "ate_scale": float(scale),
            "query_slots": slots, "loops_closed": a.loop_closer.loops_closed,
            "checkpoint": {"after_frame": ids[ckpt_at], "frames": len(nxt),
                           "records_max_diff": worst, "restored_ms_median": float(np.median(ck_ms)),
                           "keys": len(schema)}}
    log(f"[atlas] maps {atlas.maps_created}, merge {merge} (JAX frame/slot/cand/inliers "
        f"{merge['jax']}); stored map {n_kf_a} keyframes (JAX {ref['n_kf_a']}), merged {a.n_kf} "
        f"(JAX {ref['merges'][0]['n_kf']}); tracked {tracked} (JAX {ref['tracked']}), Sim(3) ATE "
        f"{ate:.5f} (JAX {ref['ate_sim3_m']:.5f}); query at pose {ref['query_pose']}: {slots} (JAX "
        f"{ref['query_slots']}); loops {a.loop_closer.loops_closed} (JAX {ref['loops_closed']}); "
        f"{meas['fps']:.2f} frames/s; {smi}")
    log(f"[atlas] 13d checkpoint after frame {ids[ckpt_at]}: {len(schema)} keys as the JAX run's, "
        f"{len(nxt)} frames restored = original (poses within {worst:.3g}); launches {launches}")
    n = len(ids)
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"atlas lap: launch counts {launches}, expected {want}")
    if atlas.maps_created != ref["maps_created"] or atlas.merges != ref["merges_total"]:
        raise AssertionError(f"atlas lap: maps {atlas.maps_created}, merges {atlas.merges}; JAX "
                             f"{ref['maps_created']}, {ref['merges_total']}")
    if abs(a.n_kf - ref["merges"][0]["n_kf"]) > ATLAS_KF_MARGIN and \
            abs(a.n_kf - ref["n_kf"]) > ATLAS_KF_MARGIN:
        raise AssertionError(f"atlas lap: {a.n_kf} keyframes, JAX {ref['n_kf']}")
    if tracked < ref["tracked"] - MONO_TRACKED_MARGIN:
        raise AssertionError(f"atlas lap: tracked {tracked} < {ref['tracked']} - 3")
    if ate > RMSE_FACTOR * ref["ate_sim3_m"] + RMSE_SLACK_M:
        raise AssertionError(f"atlas lap: ATE {ate:.5f} > 2 x {ref['ate_sim3_m']:.5f} + 2 mm")
    if not any(s_ < n_kf_a for s_ in slots):
        raise AssertionError(f"atlas lap: the pre-merge view retrieves {slots}, no pre-merge keyframe")
    return launches, meas


def run_stereo_atlas_lap(ref: dict, dev, smi) -> tuple[dict, dict]:
    """13b.  ``AtlasSLAM(StereoSLAM, fix_scale=True)`` at ``bench.py``'s
    stereo configuration: two sessions over the same orbit with
    ``on_sequence_end()`` between them, held to
    ``tests/fixtures/stereo_atlas_lap.json``."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.atlas import AtlasSLAM
    from orb_slam3_noted_tpu_torch.pipeline.system import StereoSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    poses, frames = atlas_schedule_frames(ref, "stereo")
    ids, pidx = ref["frame_ids"], ref["pose_index"]
    seq2_from = ids.index(next(f for f, p, prev in zip(ids[1:], pidx[1:], pidx) if p < prev))
    atlas = AtlasSLAM(lap_config(), StereoSLAM, fix_scale=True, device=dev)
    cur = {"frame": None}
    watch = MergeWatch(atlas, ref, lambda: cur["frame"])
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, fid in enumerate(ids):
        if k == seq2_from:
            atlas.on_sequence_end()
        cur["frame"] = fid
        atlas.process(frames[k][0], frames[k][1], fid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()
    a = atlas.active
    merge = check_merge("stereo atlas lap", watch.merges, ref,
                        lambda s: int(a.m.kf_frame_id[s]))
    est = atlas.positions()
    states = [r.state for r in atlas.trajectory]
    ok = np.asarray([s == "OK" for s in states])
    gt = np.asarray([poses[p][1] for p in pidx])
    ate, _, _ = ate_rmse(est[ok], gt[ok], with_scale=False)
    tracked = int(ok.sum())
    meas = {"fps": len(ids) / wall, "merge": merge, "tracked": tracked, "ate_se3_m": float(ate),
            "n_kf": a.n_kf, "merge_draw_stats": watch._sets.stats}
    log(f"[stereo atlas] merge {merge}; tracked {tracked} (JAX {ref['tracked']}), SE(3) ATE "
        f"{ate:.5f} (JAX {ref['ate_se3_m']:.5f}), keyframes {a.n_kf} (JAX {ref['n_kf']}); "
        f"{meas['fps']:.2f} frames/s; launches {launches}; {smi}")
    n = len(ids)
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": n,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"stereo atlas lap: launch counts {launches}, expected {want}")
    if atlas.merges != 1 or merge["s"] != 1.0:
        raise AssertionError(f"stereo atlas lap: merges {atlas.merges}, scale {merge['s']!r}")
    if tracked < ref["tracked"] - TRACKED_MARGIN:
        raise AssertionError(f"stereo atlas lap: tracked {tracked} < {ref['tracked']} - 2")
    if ate > RMSE_FACTOR * ref["ate_se3_m"] + RMSE_SLACK_M:
        raise AssertionError(f"stereo atlas lap: ATE {ate:.5f} > 2 x {ref['ate_se3_m']:.5f} + 2 mm")
    return launches, meas


def run_inertial_atlas_lap(ref: dict, dev, smi) -> tuple[dict, dict]:
    """13c.  ``InertialAtlasSLAM(MonoInertialSLAM)`` on
    tests/test_inertial_atlas.py's trajectory and settings at 752x480 and
    1200 features with the JAX run's 200 Hz IMU samples, frame by frame,
    held to ``tests/fixtures/inertial_atlas_lap.json``."""
    import torch

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.inertial_atlas import InertialAtlasSLAM, yaw_only
    from orb_slam3_noted_tpu_torch.pipeline.inertial_system import MonoInertialSLAM
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    poses, imgs = atlas_schedule_frames(ref, "mono_seed3")
    ids = ref["frame_ids"]
    imu = [tuple(b64_array(f[k], "<f8", (-1, 3) if k != "ts" else (-1,))
                 for k in ("acc", "gyr", "ts")) for f in ref["imu"]]
    cfg = SlamConfig(camera=Camera(PINHOLE, CAM_PARAMS), **ref["config"])
    Drawn = drawn_class(MonoInertialSLAM, ref)
    atlas = InertialAtlasSLAM(cfg, base_cls=Drawn, device=dev)
    cur = {"frame": None}
    watch = MergeWatch(atlas, ref, lambda: cur["frame"])
    blank = np.zeros((H, W), np.uint8)
    stages, chain, merge_k = [], None, None
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, fid in enumerate(ids):
        cur["frame"] = fid
        merged = atlas.merges
        acc, gyr, ts = imu[k]
        atlas.process(imgs[k] if imgs[k] is not None else blank, fid, t=ref["times"][k], acc=acc,
                      gyr=gyr, imu_t=ts)
        stages.append(int(atlas.active.imu_stage))
        if atlas.merges > merged:
            a = atlas.active
            merge_k = k
            chain = {"seg_ok_false": a.seg_ok.count(False), "n_seg_preints": len(a.seg_preints),
                     "n_kf_order": len(a.kf_order), "imu_stage": a.imu_stage,
                     "vel_finite": bool(torch.isfinite(a.ki.vel).all())}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()
    a = atlas.active
    both_metric = ref["merges"][0]["s"] == 1.0
    # between two metric maps the JAX package projects the wrong rotation
    # (ROADMAP Queue 3): the port is held to JAX's world transform before
    # that projection, projected onto yaw at scale 1
    unproj = ref["merge_unprojected"][0]
    jax_S = (yaw_only(np.asarray(unproj["R"])), np.asarray(unproj["t"]), 1.0) \
        if both_metric else None
    # the candidate follows the vocabulary trained on map A's descriptors
    # (loop closing is off), which the two packages' maps move: reported
    merge = check_merge("inertial atlas lap", watch.merges, ref,
                        lambda s: int(a.m.kf_frame_id[s]), mono=not both_metric,
                        hold_cand=False, jax_S=jax_S, max_deg=ATLAS_YAW_DEG, max_t=None)
    g = watch.merges[0]
    tilt = float(np.hypot(g["R"][2, 0], g["R"][2, 1]))
    jax_tilt = float(np.hypot(*np.asarray(ref["merges"][0]["R"])[2, :2]))
    yaw = lambda R: float(np.degrees(np.arctan2(R[1, 0], R[0, 0])))  # noqa: E731
    yaw_diff = abs(yaw(g["R"]) - yaw(np.asarray(unproj["R"])))
    est = atlas.positions()
    states = [r.state for r in atlas.trajectory]
    ok = np.asarray([s == "OK" and p is not None for s, p in zip(states, ref["pose_index"])])
    twc = b64_array(ref["twc_f64"], "<f8", (-1, 3))
    ate, _, _ = ate_rmse(est[ok], twc[ok], with_scale=False)
    after = int(sum(s == "OK" for s in states[merge_k + 1:]))
    j_merge_k = ids.index(ref["merges"][0]["frame_id"])
    j_after = int(sum(s == "OK" for s in ref["states"][j_merge_k + 1:]))
    first = lambda st: next(i for i, x in enumerate(st) if x >= 1)  # noqa: E731
    meas = {"fps": len(ids) / wall, "merge": merge, "both_metric": both_metric,
            "stage_frame_a": first(stages), "jax_stage_frame_a": first(ref["imu_stage"]),
            "chain_at_merge": chain, "tilt_rad": tilt, "jax_tilt_rad": jax_tilt,
            "yaw_vs_jax_deg": yaw_diff,
            "tracked_after_merge": after, "jax_tracked_after_merge": j_after,
            "ate_se3_m": float(ate), "merge_draw_stats": watch._sets.stats}
    log(f"[inertial atlas] {meas}; JAX ATE {ref['ate_se3_m']:.5f}; launches {launches}; {smi}")
    n = len(ids)
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"inertial atlas lap: launch counts {launches}, expected {want}")
    if max(stages[:30]) < 1 or abs(meas["stage_frame_a"] - meas["jax_stage_frame_a"]) > 1:
        raise AssertionError(f"inertial atlas lap: map A's IMU stage 1 at frame "
                             f"{meas['stage_frame_a']}, JAX {meas['jax_stage_frame_a']}")
    if atlas.maps_created != 2 or atlas.merges != 1:
        raise AssertionError(f"inertial atlas lap: maps {atlas.maps_created}, merges {atlas.merges}")
    if both_metric and (g["s"] != 1.0 or tilt > ATLAS_TILT_RAD or yaw_diff > ATLAS_YAW_DEG):
        raise AssertionError(f"inertial atlas lap: the 4-DoF weld: s {g['s']!r}, tilt {tilt:.3g} "
                             f"rad, yaw {yaw_diff:.3g} deg from JAX's")
    if chain is None or chain["seg_ok_false"] != 1 or \
            chain["n_seg_preints"] != chain["n_kf_order"] - 1 or not chain["vel_finite"]:
        raise AssertionError(f"inertial atlas lap: the welded chain {chain}")
    if after < j_after - 2:
        raise AssertionError(f"inertial atlas lap: tracked after the merge {after} < {j_after} - 2")
    if ate > RMSE_FACTOR * ref["ate_se3_m"] + RMSE_SLACK_M:
        raise AssertionError(f"inertial atlas lap: ATE {ate:.5f} > 2 x {ref['ate_se3_m']:.5f} + 2 mm")
    return launches, meas



# ---------------------------------------------------------------------------
# phase 14: the CLI on dataset layouts

CLI_LAYOUTS = ("cli_euroc", "cli_tum_rgbd", "cli_tumvi")
CLI_ATE_SLACK_M = 0.002      # ATE <= 2 x JAX + 2 mm, in the CLI's own --eval alignment
CLI_TRACKED_SLACK = 2        # tracked frames >= JAX - 2
CLI_KF_SLACK = 2             # keyframes within +-2 of JAX's


def _cli_layouts():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import cli_layouts

    return cli_layouts


def _render_cli_job(job):
    """One frame of a phase-14 layout, rendered by the port: ("stereo", R,
    t, camera, W, H, baseline) -> (left, right) uint8 in ``BoxRoom(seed=0)``;
    ("rgbd", R, t, camera, W, H) -> (image uint8, depth float32)."""
    from orb_slam3_noted_tpu_torch.utils.synthetic import BoxRoom, stereo_pair

    if not _ROOM:
        _ROOM.extend([BoxRoom(seed=0), BoxRoom(seed=3)])
    kind, R, t, cam, w, h = job[:6]
    if kind == "stereo":
        left, right, _ = stereo_pair(_ROOM[0], R, t, cam, w, h, job[6])
        return left.astype(np.uint8), right.astype(np.uint8)
    img, depth = _ROOM[0].render(R, t, cam, w, h, return_depth=True)
    return img.astype(np.uint8), depth.astype(np.float32)


def _warp_job(job):
    """One image of a phase-14 EuRoC layout warped to its raw camera."""
    return _cli_layouts().raw_from_rectified(*job)


def pool_warp(jobs) -> list:
    """``scripts/cli_layouts.py``'s warps over the worker pool."""
    return pool_map(_warp_job, jobs)


def cli_frames(case: dict) -> list:
    """The frames of a phase-14 layout, rendered by the port from the JAX
    runs' stored poses (the worker pool)."""
    rwc, twc = case["poses"]
    if case["kind"] == "fisheye":
        jobs = [(case["room"], case["camera1"], case["camera2"], case["rlr"], case["tlr"], R, t,
                 False) for R, t in zip(rwc, twc)]
        fn = _render_fisheye_job
    else:
        extra = (case["baseline"],) if case["kind"] == "stereo" else ()
        jobs = [(case["kind"], R, t, case["camera"], case["width"], case["height"], *extra)
                for R, t in zip(rwc, twc)]
        fn = _render_cli_job
    return pool_map(fn, jobs)


def run_cli_layout(name: str, ref: dict, si_ref: dict, fe_ref: dict, dev, smi, rendered=None):
    """Phase 14: one dataset layout written by ``scripts/cli_layouts.py``
    with the port's ``write_png`` under ``build/cli_layouts/``, then
    ``cli.main`` in this process on the card.  Held to the JAX CLI's run on
    the same files (``tests/fixtures/<name>.json``).  ``rendered``: frames
    an earlier phase rendered from the same poses (their first ``n`` are
    the layout's), else rendered here.  Returns (launch counts,
    measurements)."""
    import contextlib
    import io

    import torch

    from orb_slam3_noted_tpu_torch import cli
    from orb_slam3_noted_tpu_torch.io import datasets as D
    from orb_slam3_noted_tpu_torch.io import images
    from orb_slam3_noted_tpu_torch.io.yaml_compat import (
        load_settings,
        load_stereo_rectification,
    )
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline import tracking as T

    L = _cli_layouts()
    case = L.cases(si_ref, fe_ref)[name]
    n = case["n"]
    t0 = time.perf_counter()
    frames = cli_frames(case) if rendered is None else [tuple(f[:2]) for f in rendered[:n]]
    t_render = time.perf_counter() - t0
    root = os.path.join(ROOT, "build", "cli_layouts", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    argv = L.write_case(name, case, frames, root, si_ref, fe_ref, images.write_png,
                        warp=pool_warp)
    t_write = time.perf_counter() - t0
    settings = argv[argv.index("--settings") + 1]
    seq_dir = argv[argv.index("--seq") + 1]
    got_settings = L.settings_record(*load_settings(settings))
    if got_settings != {"config": ref["config"], "imu": ref["imu"]}:
        diff = {k: (got_settings["config"][k], ref["config"][k]) for k in ref["config"]
                if got_settings["config"][k] != ref["config"][k]}
        raise AssertionError(f"{name}: parsed settings differ from the JAX package's: {diff} "
                             f"imu {got_settings['imu']} vs {ref['imu']}")

    # decode: every frame of the layout through the loader's reader and
    # prefetcher, before the run
    seq = (D.load_tum_rgbd(seq_dir) if name == "cli_tum_rgbd"
           else D.load_euroc(seq_dir, stereo=True, with_imu=True))
    t0 = time.perf_counter()
    for i in range(len(seq)):
        seq.read(i)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(seq)
    seq.close()
    meas = {"frames_rendered": n, "render_s": t_render, "write_s": t_write,
            "decode_ms_per_frame": decode_ms, "frames_read": len(seq)}
    rect = load_stereo_rectification(settings)
    if name == "cli_euroc":
        maps = [tuple(torch.from_numpy(m).to(dev) for m in side)
                for side in D.make_rectify_maps(rect)]
        raw = torch.from_numpy(images.read_gray(seq.left_paths[0])).to(dev, torch.float32)
        meas["rectify_ms"] = device_time_ms(lambda: D.rectify(raw, maps[0]))
        meas["rectify_per_call_ms"] = cuda_time_ms(lambda: D.rectify(raw, maps[0]))
    elif rect is not None:
        raise AssertionError(f"{name}: the settings carry rectification blocks")

    counted = {}
    build = cli.build_system

    def counting_build(*args, **kw):
        slam = build(*args, **kw)
        counted["slam"] = slam
        counted["count"] = DispatchCounter(slam, ("process",))
        return slam

    clock = StageClock()
    clock.wrap(T, "stereo_frontend_batch", "frontend_batch")
    cli.build_system = counting_build
    out = io.StringIO()
    try:
        ck.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            result = cli.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        launches = ck.launch_counts()
    finally:
        cli.build_system = build
        clock.restore()
    log(f"[{name}] CLI output: {out.getvalue().strip()}")
    slam = counted["slam"]
    got = L.cli_outputs(root, result)
    batch = int(argv[argv.index("--batch") + 1]) if "--batch" in argv else 1
    dispatches = counted["count"].n["process"] + clock.n["frontend_batch"]
    meas.update({"result": result, "fps": result["fps"], "imu_stage": got["imu_stage"],
                 "traj_rows": got["traj_rows"], "metric_lines": len(got["metric_events"]),
                 "dispatches": dispatches, "card": smi})
    log(f"[{name}] {n} frames: tracked {result['tracked']} (JAX {ref['result']['tracked']}), "
        f"keyframes {result['keyframes']} (JAX {ref['result']['keyframes']}), ATE "
        f"{result.get('ate_rmse_m')} m (JAX {ref['result'].get('ate_rmse_m')}), imu_stage "
        f"{got['imu_stage']} (JAX {ref['imu_stage']}), {result['fps']} frames/s (JAX on the CPU "
        f"{ref['result']['fps']}), decode {decode_ms:.2f} ms a frame, rectify "
        f"{meas.get('rectify_ms', float('nan')):.4f} ms device / "
        f"{meas.get('rectify_per_call_ms', float('nan')):.4f} ms per call an image; "
        f"render {t_render:.1f} s, write {t_write:.1f} s; launches {launches}, extraction dispatches {dispatches}; {smi}")

    want = {"fast_candidates": dispatches, "gaussian_blur7": dispatches, "brief_sample": dispatches,
            "sad_stereo": dispatches if name == "cli_euroc" else 0, "fast_score": 0}
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, expected {want}")
    if result["frames"] != ref["result"]["frames"]:
        raise AssertionError(f"{name}: {result['frames']} frames, JAX {ref['result']['frames']}")
    if result["tracked"] < ref["result"]["tracked"] - CLI_TRACKED_SLACK:
        raise AssertionError(f"{name}: tracked {result['tracked']} < JAX "
                             f"{ref['result']['tracked']} - {CLI_TRACKED_SLACK}")
    if abs(result["keyframes"] - ref["result"]["keyframes"]) > CLI_KF_SLACK:
        raise AssertionError(f"{name}: {result['keyframes']} keyframes, JAX "
                             f"{ref['result']['keyframes']}")
    ate_max = 2.0 * ref["result"]["ate_rmse_m"] + CLI_ATE_SLACK_M
    if not result.get("ate_rmse_m", np.inf) <= ate_max:
        raise AssertionError(f"{name}: ATE {result.get('ate_rmse_m')} m > {ate_max:.4f} m")
    if got["imu_stage"] != ref["imu_stage"]:
        raise AssertionError(f"{name}: imu_stage {got['imu_stage']}, JAX {ref['imu_stage']}")
    if got["traj_rows"] != len(slam.trajectory):
        raise AssertionError(f"{name}: {got['traj_rows']} trajectory rows for "
                             f"{len(slam.trajectory)} records")
    n_dispatch = -(-result["frames"] // batch)
    if got["metric_events"] != ["dispatch"] * n_dispatch + ["final"]:
        raise AssertionError(f"{name}: metric events {got['metric_events']}, expected "
                             f"{n_dispatch} dispatch lines and a final one")
    if got.get("checkpoint") != ref.get("checkpoint"):
        raise AssertionError(f"{name}: checkpoint keys/dtypes {got.get('checkpoint')} differ "
                             f"from the JAX CLI's {ref.get('checkpoint')}")
    return launches, meas


# ---------------------------------------------------------------------------
# phase 15: the live node and the viewer

def start_server(node):
    """The port's ``serve(node)`` on 127.0.0.1, an ephemeral port, in a
    thread; returns (the producer's socket, the thread, [what serve raised])."""
    import socket
    import threading

    from orb_slam3_noted_tpu_torch import node as N

    ready, bound, raised = threading.Event(), [], []

    def run():
        try:
            N.serve(node, "127.0.0.1", 0, ready_event=ready, _bound=bound)
        except BaseException as e:
            raised.append(e)
            ready.set()

    th = threading.Thread(target=run, daemon=True, name="serve")
    th.start()
    if not ready.wait(60) or not bound:
        raise AssertionError(f"node server did not start: {raised}")
    return socket.create_connection(bound[0], timeout=NODE_RECV_TIMEOUT_S), th, raised


def img_msg(t, img) -> bytes:
    h, w = img.shape
    return struct.pack("<dII", t, w, h) + np.ascontiguousarray(img, np.uint8).tobytes()


def img2_msg(img, dtype) -> bytes:
    h, w = img.shape
    return struct.pack("<II", w, h) + np.ascontiguousarray(img, dtype).tobytes()


def recv_json(cli):
    from orb_slam3_noted_tpu_torch.node import _recv_msg

    tag, payload = _recv_msg(cli)
    return tag, json.loads(bytes(payload))


def node_imu_blocks(times, acc, gyr, ts) -> list:
    """Each frame's IMUS samples: those after the previous frame's block up
    to and including the frame's time (``scripts/torch_port_reference_lap.py
    --mode node_stereo_inertial`` splits them the same way)."""
    out, start = [], 0
    for t in times:
        stop = int(np.searchsorted(ts, t + 1e-9, side="right"))
        out.append(np.column_stack([ts[start:stop], acc[start:stop], gyr[start:stop]]))
        start = stop
    return out


def finish_node(cli, th, raised, node, tag: str) -> dict:
    """DONE, then FINI; the server thread ends and the worker raised
    nothing."""
    from orb_slam3_noted_tpu_torch.node import _send_msg

    _send_msg(cli, b"DONE", b"")
    while True:
        kind, msg = recv_json(cli)
        if kind == b"FINI":
            break
    cli.close()
    th.join(60)
    if th.is_alive() or raised or node.error is not None:
        raise AssertionError(f"{tag}: server alive {th.is_alive()}, raised {raised}, worker "
                             f"{node.error!r}")
    return msg


def latency_stats(ms: list) -> dict:
    a = np.asarray(ms[1:], np.float64)
    return {"first_ms": float(ms[0]), "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)), "max_ms": float(a.max())}


def run_node_si(ref: dict, si_ref: dict, si_in, dev, smi) -> tuple[dict, dict]:
    """15a: the stereo-inertial node over TCP, lock-step: per frame one
    IMUS block (the samples up to the frame's time), IMG0 and IMG1, then
    its POSE before the next frame.  Held to the JAX node's run
    (``tests/fixtures/node_stereo_inertial.json``)."""
    from orb_slam3_noted_tpu_torch import node as N
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.utils.evaluation import ate_rmse

    n = ref["frames"]
    if ref["config"] != si_ref["config"] or ref["bf"] != si_ref["bf"]:
        raise AssertionError("15a: the node fixture's configuration is not phase 11's")
    twc, times, pairs, chunks = si_in
    acc, gyr, ts = (np.concatenate([c[k] for c in chunks]) for k in range(3))
    blocks = node_imu_blocks(times[:n], acc, gyr, ts)
    if [len(b) for b in blocks] != ref["imu_per_frame"]:
        raise AssertionError("15a: IMU blocks differ from the JAX run's")
    node = N.SlamNode(si_config(si_ref), "stereo-inertial", device=dev)
    ck.reset_launch_counts()
    cli, th, raised = start_server(node)
    poses, lat = [], []
    t0 = time.perf_counter()
    for k in range(n):
        N._send_msg(cli, b"IMUS", struct.pack("<I", len(blocks[k]))
                    + np.ascontiguousarray(blocks[k], "<f8").tobytes())
        ts_send = time.perf_counter()
        N._send_msg(cli, b"IMG0", img_msg(times[k], pairs[k][0]))
        N._send_msg(cli, b"IMG1", img2_msg(pairs[k][1], np.uint8))
        kind, msg = recv_json(cli)
        lat.append((time.perf_counter() - ts_send) * 1e3)
        if kind != b"POSE" or msg.get("frame_id") != k:
            raise AssertionError(f"15a: frame {k}: {kind} {msg}")
        poses.append(msg)
    wall = time.perf_counter() - t0
    fini = finish_node(cli, th, raised, node, "15a")
    launches = ck.launch_counts()
    slam = node.slam
    states = [p["state"] for p in poses]
    ok = np.asarray([st == "OK" for st in states])
    est = np.asarray([p["twc"] for p in poses], np.float64)
    ate = float(ate_rmse(est[ok], twc[:n][ok], with_scale=False)[0])
    meas = {"frames": n, "tracked": int(ok.sum()), "ate_se3_m": ate, "imu_stage": slam.imu_stage,
            "n_kf": slam.n_kf, "kf_inserted": slam.kf_inserted, "fini": fini,
            "fps": n / wall, "latency": latency_stats(lat), "card": smi}
    log(f"[node 15a] tracked {meas['tracked']}/{n} (JAX {ref['tracked']}), ATE SE(3) of the "
        f"published twc {ate * 1e3:.2f} mm (JAX {ref['ate_se3_m'] * 1e3:.2f}), imu_stage "
        f"{slam.imu_stage} (JAX {ref['imu_stage']}), keyframes {slam.n_kf} (JAX {ref['n_kf']}); "
        f"{meas['fps']:.2f} frames/s lock-step, round trip (IMG0 sent to POSE received) "
        f"{json.dumps(meas['latency'])}; launches {launches}; {smi}")
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": n,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"15a: launch counts {launches}, expected {want}")
    if len(poses) != n or fini["n_frames"] != n:
        raise AssertionError(f"15a: {len(poses)} POSE records, FINI {fini}")
    if meas["tracked"] < ref["tracked"] - NODE_TRACKED_MARGIN:
        raise AssertionError(f"15a: tracked {meas['tracked']} < {ref['tracked']} - "
                             f"{NODE_TRACKED_MARGIN}")
    if ate > RMSE_FACTOR * ref["ate_se3_m"] + RMSE_SLACK_M:
        raise AssertionError(f"15a: ATE {ate:.5f} m > 2 x {ref['ate_se3_m']:.5f} + 2 mm")
    if slam.imu_stage != ref["imu_stage"]:
        raise AssertionError(f"15a: imu_stage {slam.imu_stage}, JAX {ref['imu_stage']}")
    if abs(slam.n_kf - ref["n_kf"]) > NODE_SI_KF_MARGIN:
        raise AssertionError(f"15a: {slam.n_kf} keyframes, JAX {ref['n_kf']}")
    return launches, meas


def timed_get(port: int, path: str) -> tuple[bytes, float]:
    import urllib.request

    t0 = time.perf_counter()
    body = urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=60).read()
    return body, (time.perf_counter() - t0) * 1e3


def run_node_rgbd(ref: dict, cfg, poses, frames, dev, smi) -> tuple[dict, dict]:
    """15b: the RGB-D node (the mapper on) over TCP, IMG0 + DPT1 lock-step,
    the overlay on and a ``LiveViewer`` on the same system: ``/state.json``
    and ``/frame.png`` after frames 24 and 48, then ``export_map_html`` and
    ``save_map_png``.  Held to the JAX node's run
    (``tests/fixtures/node_rgbd.json``)."""
    from orb_slam3_noted_tpu_torch.io.images import decode_png
    from orb_slam3_noted_tpu_torch import node as N
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.utils import viewer as V

    n = ref["frames"]
    node = N.SlamNode(cfg, "rgbd", device=dev)
    slam = node.slam
    slam.keep_frame_overlay = True
    matched = []

    def on_pose(msg):  # in the worker thread, right after the frame
        ov = slam.last_overlay
        matched.append(None if ov is None or ov["frame_id"] != msg.get("frame_id")
                       else int((ov["valid"] & ov["matched"]).sum()))

    node.subscribe(on_pose)
    viewer = V.LiveViewer(slam, port=0, host="127.0.0.1")
    out_dir = os.path.join(ROOT, "build", "node_viewer")
    os.makedirs(out_dir, exist_ok=True)
    views, pub, rts = [], [], []
    try:
        ck.reset_launch_counts()
        cli, th, raised = start_server(node)
        for k in range(n):
            img, _, depth = frames[k]
            t_rt = time.perf_counter()
            N._send_msg(cli, b"IMG0", img_msg(k / NODE_CAMERA_FPS, img))
            N._send_msg(cli, b"DPT1", img2_msg(depth, "<f4"))
            kind, msg = recv_json(cli)
            rts.append((time.perf_counter() - t_rt) * 1e3)
            if kind != b"POSE" or msg.get("frame_id") != k:
                raise AssertionError(f"15b: frame {k}: {kind} {msg}")
            pub.append(msg)
            if k + 1 in NODE_VIEW_FRAMES:
                state, ms_state = timed_get(viewer.port, "state.json")
                png, ms_png = timed_get(viewer.port, "frame.png")
                with slam.lock:  # the node is idle between POSE and the next frame
                    kf_valid, mp_valid = (int(x.sum()) for x in (slam.m.kf_valid,
                                                                 slam.m.mp_valid))
                    want = V.draw_frame(slam.last_image, slam.last_overlay)[:, :, ::-1]
                st = json.loads(state)
                got = decode_png(png)
                if (st["n_kf"], st["n_mp"]) != (kf_valid, mp_valid):
                    raise AssertionError(f"15b: state.json counts {st['n_kf']}, {st['n_mp']}; "
                                         f"the map {kf_valid}, {mp_valid}")
                if got.shape != (H + V.STATUS_ROWS, W, 3) or not np.array_equal(got, want):
                    raise AssertionError(f"15b: /frame.png {got.shape} differs from draw_frame")
                views.append({"frame": k + 1, "state_json_ms": ms_state, "frame_png_ms": ms_png,
                              "state_json_bytes": len(state), "frame_png_bytes": len(png),
                              "n_kf": st["n_kf"], "n_mp": st["n_mp"]})
        fini = finish_node(cli, th, raised, node, "15b")
        launches = ck.launch_counts()
        t0 = time.perf_counter()
        html_path = V.export_map_html(slam, os.path.join(out_dir, "map.html"))
        ms_html = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        png_path = V.save_map_png(slam, os.path.join(out_dir, "map.png"))
        ms_map = (time.perf_counter() - t0) * 1e3
    finally:
        viewer.close()
    html = open(html_path).read()
    head, tail = V._HTML_TEMPLATE.split("__DATA__")
    if (not html.startswith(head) or not html.endswith(tail)
            or json.loads(html[len(head):len(html) - len(tail)]) != V.map_snapshot(slam)):
        raise AssertionError("15b: export_map_html does not embed map_snapshot's dict")
    map_img = decode_png(open(png_path, "rb").read())
    if map_img.shape != (V.PANEL, 2 * V.PANEL, 3):
        raise AssertionError(f"15b: save_map_png decodes to {map_img.shape}")
    states = [p["state"] for p in pub]
    tracked = sum(st == "OK" for st in states)
    gt = np.asarray([t for _, t in poses[:n]])
    Rwc0, twc0 = poses[0]
    err = np.linalg.norm(np.asarray([p["twc"] for p in pub]) - (gt - twc0) @ Rwc0, axis=1)
    rmse = float(np.sqrt((err ** 2).mean()))
    meas = {"frames": n, "tracked": tracked, "rmse_m": rmse, "n_kf": slam.n_kf,
            "matched_last": matched[-1], "matched_last_jax": ref["overlay_matched"][-1],
            "views": views, "export_map_html_ms": ms_html, "save_map_png_ms": ms_map,
            "fps": n / (sum(rts) / 1e3), "latency": latency_stats(rts), "fini": fini, "card": smi}
    log(f"[node 15b] tracked {tracked}/{n} (JAX {ref['tracked']}), RMSE of the published twc "
        f"{rmse * 1e3:.2f} mm (JAX {ref['rmse_m'] * 1e3:.2f}), keyframes {slam.n_kf} (JAX "
        f"{ref['n_kf']}), matched on the last frame {matched[-1]} (JAX "
        f"{ref['overlay_matched'][-1]}); viewer {json.dumps(views)}; export_map_html "
        f"{ms_html:.1f} ms, save_map_png {ms_map:.1f} ms; {meas['fps']:.2f} frames/s over the "
        f"round trips, {json.dumps(meas['latency'])}; launches {launches}; {smi}")
    want = {"fast_candidates": n, "gaussian_blur7": n, "brief_sample": n, "sad_stereo": 0,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"15b: launch counts {launches}, expected {want}")
    if len(pub) != n or fini["n_frames"] != n:
        raise AssertionError(f"15b: {len(pub)} POSE records, FINI {fini}")
    if tracked < ref["tracked"] - NODE_TRACKED_MARGIN:
        raise AssertionError(f"15b: tracked {tracked} < {ref['tracked']} - {NODE_TRACKED_MARGIN}")
    if rmse > RMSE_FACTOR * ref["rmse_m"] + RMSE_SLACK_M:
        raise AssertionError(f"15b: RMSE {rmse:.5f} m > 2 x {ref['rmse_m']:.5f} + 2 mm")
    if abs(slam.n_kf - ref["n_kf"]) > NODE_RGBD_KF_MARGIN:
        raise AssertionError(f"15b: {slam.n_kf} keyframes, JAX {ref['n_kf']}")
    if matched[-1] is None or matched[-1] < NODE_MATCHED_SHARE * ref["overlay_matched"][-1]:
        raise AssertionError(f"15b: {matched[-1]} matched keypoints on the last frame, JAX "
                             f"{ref['overlay_matched'][-1]}")
    return launches, meas


def run_node_realtime(cfg, frames, dev, smi) -> tuple[dict, dict]:
    """15c: the stereo node with ``realtime`` (drop the backlog to the
    newest frame), the pairs sent at camera rate without waiting for poses;
    a reader thread takes the POSE records as they come."""
    import threading

    from orb_slam3_noted_tpu_torch import node as N
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    n = len(frames)
    node = N.SlamNode(cfg, "stereo", realtime=True, device=dev)
    ck.reset_launch_counts()
    cli, th, raised = start_server(node)
    got, fini, failed = [], [], []

    def reader():
        try:
            while True:
                kind, msg = recv_json(cli)
                if kind == b"FINI":
                    fini.append(msg)
                    return
                got.append((time.perf_counter(), msg))
        except BaseException as e:
            failed.append(e)

    rt = threading.Thread(target=reader, daemon=True, name="pose-reader")
    rt.start()
    sent = {}
    t0 = time.perf_counter()
    for k in range(n):
        lag = t0 + k / NODE_CAMERA_FPS - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        t = k / NODE_CAMERA_FPS
        sent[t] = time.perf_counter()
        N._send_msg(cli, b"IMG0", img_msg(t, frames[k][0]))
        N._send_msg(cli, b"IMG1", img2_msg(frames[k][1], np.uint8))
    N._send_msg(cli, b"DONE", b"")
    rt.join(NODE_RECV_TIMEOUT_S)
    wall = time.perf_counter() - t0
    th.join(60)
    cli.close()
    launches = ck.launch_counts()
    if failed or not fini or rt.is_alive() or th.is_alive() or raised or node.error is not None:
        raise AssertionError(f"15c: reader {failed}, FINI {fini}, server {raised}, worker "
                             f"{node.error!r}")
    fini = fini[0]
    ts = [m["t"] for _, m in got]
    lat = [(tr - sent[m["t"]]) * 1e3 for tr, m in got]
    meas = {"frames": n, "n_published": node.n_published, "n_dropped": node.n_dropped,
            "tracked": sum(m["state"] == "OK" for _, m in got), "fini": fini,
            "latency": latency_stats(lat) if len(lat) > 1 else None, "wall_s": wall, "card": smi}
    log(f"[node 15c] {n} pairs at {NODE_CAMERA_FPS:g} frames/s: published {node.n_published}, "
        f"dropped {node.n_dropped}, tracked {meas['tracked']}, round trip "
        f"{json.dumps(meas['latency'])}; launches {launches}; {smi}")
    if node.n_published + node.n_dropped != n or len(got) != node.n_published:
        raise AssertionError(f"15c: published {node.n_published} + dropped {node.n_dropped} "
                             f"!= {n}, or {len(got)} POSE records")
    if fini["n_frames"] != node.n_published:
        raise AssertionError(f"15c: FINI {fini}, published {node.n_published}")
    if any(b <= a for a, b in zip(ts, ts[1:])):
        raise AssertionError(f"15c: POSE times not increasing: {ts}")
    k = node.n_published
    want = {"fast_candidates": k, "gaussian_blur7": k, "brief_sample": k, "sad_stereo": k,
            "fast_score": 0}
    if launches != want:
        raise AssertionError(f"15c: launch counts {launches}, expected {want}")
    return launches, meas


# ---------------------------------------------------------------------------
# phase 16: distribution on one card

# the GBA's LM steps (Huber, plain) and PCG iterations in every 16a run, one
# device and sharded: the loop closer's sharded GBA
DIST_GBA_ITERS = (6, 4, 32)
DIST_GBA_POSE_TOL = 1e-3   # rotation entries and metres, against one device
DIST_GBA_POINT_M = 2e-3    # median point distance from one device's
DIST_GBA_COST_REL = 0.01
DIST_PG_TOL = 1e-4         # the pose graph against one device's (R, t, s)
DIST_LOOP_PG_TOL = 1e-4    # 16c after the sharded pose graph
DIST_LOOP_GBA_TOL = 1e-3   # 16c after the sharded GBA, against run_global_ba
DIST_REPS = 2              # calls of each job: the first one warms the card and the group
DIST_CLOSER_KW = dict(min_inliers=20, consistency_th=0)  # as phase 10b


def _dist():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_port_dist

    return torch_port_dist


def _max_diff(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def _same_bits(x, y) -> bool:
    """Every tensor in two results of one job equal bit for bit."""
    import torch

    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    if isinstance(x, dict):
        return all(_same_bits(x[k], y[k]) for k in x)
    if isinstance(x, (tuple, list)):
        return all(_same_bits(a, b) for a, b in zip(x, y))
    return x == y


def run_distribution(ref_corr: dict, dev, smi) -> dict:
    """Phase 16: the distributed paths on the card, each against its
    one-device counterpart in this process.  16a the full-capacity GBA of
    the JAX package's multi-device dry run (``scripts/torch_port_dist.py``:
    256 keyframes, 16,384 points, 307,200 observations) through
    ``distributed_global_ba``; 16b its 256-keyframe essential graph (~1,700
    edges) through ``distributed_pose_graph_sim3``; both on a one-rank NCCL
    group in this process, then with 16c on two ranks sharing the card over
    gloo with CUDA tensors, spawned once: 16c the loop closer on phase 10b's
    full-width drifted map in that group, which must take its sharded pose
    graph and sharded GBA.  Returns the measurements."""
    import tempfile

    import torch

    from orb_slam3_noted_tpu_torch.io.config import SlamConfig
    from orb_slam3_noted_tpu_torch.models.cameras import Camera, PINHOLE
    from orb_slam3_noted_tpu_torch.optim.gba import global_bundle_adjust, run_global_ba
    from orb_slam3_noted_tpu_torch.optim.pose_graph import optimize_pose_graph_sim3
    from orb_slam3_noted_tpu_torch.parallel.dist_ba import Group, make_mesh, spawn_mesh
    from orb_slam3_noted_tpu_torch.place.pretrained import load_default_vocabulary

    TD, LS = _dist(), _scaffold()
    t_phase = time.perf_counter()
    cam = Camera(PINHOLE, TD.PIN)
    n1, n2, cg = DIST_GBA_ITERS
    gba_kw = dict(n_iters=n1, n_iters_final=n2, cg_iters=cg)
    prob = TD.capacity_gba_problem()
    graph = TD.capacity_pose_graph(prob)
    full = LS.FULL
    inp = LS.drifted_map_inputs(seed=ref_corr["seed"], baseline=tuple(ref_corr["baseline"]),
                                **full)
    cfg = SlamConfig(camera=Camera(PINHOLE, full["cam"]), width=full["width"],
                     height=full["height"], n_features=full["n_pts"],
                     max_keyframes=full["max_keyframes"], max_map_points=full["max_map_points"])
    vocab, idf = load_default_vocabulary()
    jobs = {"gba": ("global_ba", (cam, prob), gba_kw), "pose_graph": ("pose_graph", graph, {})}
    log(f"[dist] 16a GBA {prob.Rcw.shape[0]} keyframes, {prob.points.shape[0]} points, "
        f"{prob.obs.valid.shape[0]} observations, {n1} + {n2} LM steps of {cg} PCG iterations; "
        f"16b pose graph {graph[0].shape[0]} keyframes, {graph[3].i.shape[0]} edges; 16c the "
        f"loop closer on {full['n_kf']} keyframes, {2 * full['n_pts']} points")

    def timed(fn, *args, **kw):
        ms = []
        for _ in range(DIST_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    # one device, no process group: the references
    single, single_ms = timed(global_bundle_adjust, cam, TD.to_device(prob, dev), **gba_kw)
    pg_single, pg_ms = timed(optimize_pose_graph_sim3, *TD.to_device(graph, dev))
    loop1 = TD.loop_closer(make_mesh(1, device=dev), inp, cfg, vocab, idf, **DIST_CLOSER_KW)
    if (not loop1["closed"] or loop1["calls"] != {"pose_graph": 0, "gba": 0}
            or not loop1["sliced_gba"]):
        raise AssertionError(f"16c one device: {loop1['loop_edges']}, {loop1['calls']}")
    loop1_gba, _ = run_global_ba(loop1["map"], cfg.camera, cfg, cfg.bf, n1, n2, cg)
    # a one-rank NCCL group in this process, then two ranks over gloo
    with tempfile.TemporaryDirectory() as tmp, Group(tmp, 0, 1, "nccl", dev) as mesh:
        one = TD.run_jobs(mesh, jobs, reps=DIST_REPS)
    t_spawn = time.perf_counter()
    two = spawn_mesh(2, TD.run_jobs, {**jobs, "loop": (
        "loop_closer", (inp, cfg, vocab, idf), DIST_CLOSER_KW)}, DIST_REPS, backend="gloo",
        device=dev)
    spawn_s = time.perf_counter() - t_spawn

    meas = {"gba": {"one_device_ms": single_ms, "one_device_cost": float(single.cost)},
            "pose_graph": {"one_device_ms": pg_ms}, "loop": {}}
    runs = {"nccl_1_rank": one, "gloo_2_ranks": two[0]}
    for tag, res in runs.items():
        R, t, p, cost = res["gba"]["out"]
        d = np.linalg.norm((p.double().cpu() - single.points.double().cpu()).numpy(), axis=1)
        g = {"ms": res["gba"]["ms"], "collectives": res["gba"]["collectives"],
             "pose_err": max(_max_diff(R, single.Rcw), _max_diff(t, single.tcw)),
             "median_point_m": float(np.median(d)), "cost": float(cost),
             "cost_rel": abs(float(cost) - float(single.cost)) / float(single.cost)}
        meas["gba"][tag] = g
        Rg, tg, sg, _ = res["pose_graph"]["out"]
        pg = {"ms": res["pose_graph"]["ms"], "collectives": res["pose_graph"]["collectives"],
              "err": max(_max_diff(a, b) for a, b in zip((Rg, tg, sg), pg_single[:3]))}
        meas["pose_graph"][tag] = pg
        if (g["pose_err"] > DIST_GBA_POSE_TOL or g["median_point_m"] > DIST_GBA_POINT_M
                or not np.isfinite(g["cost"]) or g["cost_rel"] > DIST_GBA_COST_REL):
            raise AssertionError(f"16a {tag}: {g}")
        if pg["err"] > DIST_PG_TOL:
            raise AssertionError(f"16b {tag}: {pg}")
    if not all(_same_bits(two[0][k]["out"], two[1][k]["out"]) for k in two[0]):
        raise AssertionError("16: the two ranks' results differ")
    lp = two[0]["loop"]["out"]
    mg = lp["map"]
    err, before = LS.corrected_point_errors(mg.mp_pos.numpy(), inp)
    loop = {"ms": two[0]["loop"]["ms"], "collectives": lp["collectives"],
            "loop_edges": lp["loop_edges"], "calls": lp["calls"],
            "pose_graph_err": max(_max_diff(lp["before_gba"]["R"], loop1["map"].kf_Rcw),
                                  _max_diff(lp["before_gba"]["t"], loop1["map"].kf_tcw)),
            "gba_err": max(_max_diff(mg.kf_Rcw, loop1_gba.kf_Rcw),
                           _max_diff(mg.kf_tcw, loop1_gba.kf_tcw)),
            "median_point_err_m": float(np.median(err)),
            "median_drift_before_m": float(np.median(before))}
    meas["loop"] = loop
    meas["two_rank_spawn_s"] = spawn_s
    meas["seconds"] = time.perf_counter() - t_phase
    ms = lambda v: "/".join(f"{x:.1f}" for x in v)
    for name, m in (("16a GBA", meas["gba"]), ("16b pose graph", meas["pose_graph"])):
        log(f"[dist] {name}: one device {ms(m['one_device_ms'])} ms a call; one-rank NCCL "
            f"{ms(m['nccl_1_rank']['ms'])} ms, {m['nccl_1_rank']['collectives']} collectives a "
            f"call; two ranks sharing one card (gloo, CUDA tensors: the protocol's cost, not "
            f"scaling) {ms(m['gloo_2_ranks']['ms'])} ms, {m['gloo_2_ranks']['collectives']} "
            f"collectives a call; {smi}")
    log(f"[dist] 16c loop closer, two ranks sharing one card: {ms(loop['ms'])} ms a call (the "
        f"map built, the database filled, detection, ladder, sharded pose graph and GBA), "
        f"{loop['collectives']} collectives; "
        f"calls {loop['calls']}; after the pose graph {loop['pose_graph_err']:.3g} from one "
        f"device's, after the GBA {loop['gba_err']:.3g} from run_global_ba's; median corrected "
        f"point {loop['median_point_err_m']:.3g} m from the truth (drift before "
        f"{loop['median_drift_before_m']:.3f} m)")
    log(f"[dist] {json.dumps(meas, default=float)}")
    if (not lp["closed"] or lp["loop_edges"] != [(full["n_kf"] - 1, 0)]
            or lp["calls"] != {"pose_graph": 1, "gba": 1} or lp["sliced_gba"]):
        raise AssertionError(f"16c: the sharded branches were not taken: {loop}")
    if loop["pose_graph_err"] > DIST_LOOP_PG_TOL or loop["gba_err"] > DIST_LOOP_GBA_TOL:
        raise AssertionError(f"16c: poses off the one-device correction: {loop}")
    if loop["median_point_err_m"] > CORR_POINT_M:
        raise AssertionError(f"16c: median point error {loop['median_point_err_m']} m")
    return meas


# ---------------------------------------------------------------------------
# phase 17: the batch modes of RGB-D and fisheye stereo

def drive_batch_lap(slam, frames) -> tuple[float, list]:
    """``process`` until initialised, then ``process_batch`` in batches of
    ``BATCH``; (wall seconds with the card synced at the end, ms of each
    ``process_batch`` call on the host clock)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i, calls = 0, []
    while i < len(frames) and slam.state == "NOT_INITIALIZED":
        slam._process_one(frames[i], i)
        i += 1
    while i < len(frames):
        j = min(i + BATCH, len(frames))
        tb = time.perf_counter()
        slam.process_batch(frames[i:j], list(range(i, j)))
        calls.append((time.perf_counter() - tb) * 1e3)
        i = j
    torch.cuda.synchronize()
    return time.perf_counter() - t0, calls


def batch_lap_times(calls: list) -> dict:
    """Host ms of a lap's ``process_batch`` calls: the first (which follows
    the initialisation), then the median and the largest of the rest."""
    return {"batch_ms_first": calls[0], "batch_ms_p50": float(np.median(calls[1:])),
            "batch_ms_max": float(max(calls[1:]))}


def batch_lap_counts(tag: str, count, launches) -> dict:
    """Dispatch and copy counts of a batch lap, held: K1-K3 once per
    extraction dispatch (a batch or a frame-by-frame frame), K4 and K1's
    dense form never, one bulk copy back per tracking dispatch."""
    extraction = count.n["_batch_track"] + count.n["process"]
    tracking = count.n["_batch_track"] + count.n["_batch_retrack"]
    want = {"fast_candidates": extraction, "gaussian_blur7": extraction,
            "brief_sample": extraction, "sad_stereo": 0, "fast_score": 0}
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, expected {want}")
    if count.n["_host_copy"] != tracking:
        raise AssertionError(f"{tag}: {count.n['_host_copy']} copies back for {tracking} "
                             "tracking dispatches")
    return {"extraction_dispatches": extraction, "tracking_dispatches": tracking,
            "copies_back_per_tracking_dispatch": count.n["_host_copy"] / tracking,
            "calls": dict(count.n)}


def kf_xy_r_rows(slam) -> int:
    """Second-camera rows (a right pixel) over the map's valid keyframes."""
    return int(((slam.m.kf_xy_r[..., 0] >= 0) & slam.m.kf_valid[:, None]).sum())


def run_fisheye_batch_lap(ref: dict, inputs, fe: dict, dev, smi) -> tuple[dict, dict]:
    """17a: ``FisheyeStereoSLAM.process_batch`` at B = 16 over phase 12's
    pairs (frame 0 through ``process``), loop closing off as in 12a, held to
    the JAX run frame by frame (``FE_*``) and to 12a's second-camera rows.
    Returns (launch counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import FisheyeStereoSLAM

    twc, pairs, _ = inputs
    n = min(len(pairs), FE_BATCH_LAP_FRAMES)
    cfg = fisheye_config(ref)
    staged = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for a, b in pairs[:n]]
    slam = FisheyeStereoSLAM(cfg, device=dev)
    count = DispatchCounter(slam, BATCH_LAP_CALLS)
    ck.reset_launch_counts()
    wall, calls = drive_batch_lap(slam, staged)
    launches = ck.launch_counts()
    est = slam.positions()
    states = [r.state for r in slam.trajectory]
    if len(states) != n or not np.all(np.isfinite(est)):
        raise AssertionError(f"17a: {len(states)} records for {n} frames, or not finite")
    ok = np.asarray([s == "OK" for s in states])
    ate0, ate_se3 = fisheye_ate(est, twc[:n], ok)
    # the JAX run over the same frames
    ref_ok = np.asarray([s == "OK" for s in ref["states"][:n]])
    ref_ate0 = fisheye_ate(np.asarray(ref["positions"])[:n], twc[:n], ref_ok)[0]
    rows = kf_xy_r_rows(slam)
    meas = {"frames": n, "tracked": int(ok.sum()), "tracked_jax": int(ref_ok.sum()),
            "n_kf": slam.n_kf, "n_kf_jax": ref["n_kf"], "kf_inserted": slam.kf_inserted,
            "n_mp": slam.n_mp, "ate_origin_rmse_m": ate0, "ate_origin_rmse_m_jax": ref_ate0,
            "ate_se3_m": ate_se3, "kf_xy_r_rows": rows, "kf_xy_r_rows_12a": fe["kf_xy_r_rows"],
            "fps": n / wall, "wall_s": wall, "fps_12a": fe["fps"],
            **batch_lap_times(calls), **batch_lap_counts("17a", count, launches), "card": smi}
    meas["host_ms_per_tracking_dispatch"] = sum(calls) / meas["tracking_dispatches"]
    log(f"[fisheye batch] tracked {meas['tracked']}/{n} (JAX {meas['tracked_jax']}), keyframes "
        f"{slam.n_kf} (JAX {ref['n_kf']}), ATE with the first pose's offset removed "
        f"{ate0 * 1e3:.2f} mm (JAX frame by frame {ref_ate0 * 1e3:.2f}), second-camera rows "
        f"{rows} (12a {fe['kf_xy_r_rows']}); {meas['fps']:.2f} frames/s (12a frame by frame "
        f"{fe['fps']:.2f}), batch ms first {calls[0]:.1f}, p50 {meas['batch_ms_p50']:.1f}, max "
        f"{meas['batch_ms_max']:.1f}, host ms a tracking dispatch "
        f"{meas['host_ms_per_tracking_dispatch']:.1f} (12a a frame {1e3 / fe['fps']:.1f}); "
        f"calls {meas['calls']}; launches {launches}; {smi}")
    if meas["tracked"] < meas["tracked_jax"] - FE_TRACKED_MARGIN:
        raise AssertionError(f"17a: tracked {meas['tracked']}, JAX {meas['tracked_jax']}")
    if ate0 > 2.0 * ref_ate0 + 0.002:
        raise AssertionError(f"17a: ATE {ate0:.5f} m > 2 x {ref_ate0:.5f} + 2 mm")
    if abs(slam.n_kf - ref["n_kf"]) > FE_KF_MARGIN:
        raise AssertionError(f"17a: {slam.n_kf} keyframes, JAX {ref['n_kf']}")
    if rows < FE_XYR_SHARE * fe["kf_xy_r_rows"]:
        raise AssertionError(f"17a: {rows} second-camera rows, 12a {fe['kf_xy_r_rows']}")
    return launches, meas


def track_time_rmse(slam, poses) -> float:
    """Metric RMSE of the camera centres of the trajectory records, the
    poses as tracked (as the node publishes them, 15b), against the ground
    truth in the first camera's frame."""
    twc = np.asarray([-np.asarray(r.Rcw, np.float64).T @ np.asarray(r.tcw, np.float64)
                      for r in slam.trajectory])
    gt = np.asarray([t for _, t in poses])
    Rwc0, twc0 = poses[0]
    err = np.linalg.norm(twc - (gt - twc0) @ Rwc0, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def run_rgbd_batch_lap(ref: dict, cfg, poses, frames, node: dict, dev, smi) -> tuple[dict, dict]:
    """17b: ``RGBDSLAM.process_batch`` at B = 16 with the mapper over phase
    4's 48 frames and depth maps (frame 0 through ``process``), held to the
    JAX run frame by frame (``node_rgbd.json``, as 15b).  Returns (launch
    counts, measurements)."""
    import torch

    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck
    from orb_slam3_noted_tpu_torch.pipeline.system import RGBDSLAM

    n = ref["frames"]
    staged = [(torch.from_numpy(img).to(dev), torch.from_numpy(depth).to(dev))
              for img, _, depth in frames[:n]]
    slam = RGBDSLAM(cfg, device=dev)
    count = DispatchCounter(slam, BATCH_LAP_CALLS)
    ck.reset_launch_counts()
    wall, calls = drive_batch_lap(slam, staged)
    launches = ck.launch_counts()
    states = [r.state for r in slam.trajectory]
    if len(states) != n:
        raise AssertionError(f"17b: {len(states)} records for {n} frames")
    rmse = track_time_rmse(slam, poses[:n])
    if not np.isfinite(rmse):
        raise AssertionError("17b: poses not finite")
    tracked = sum(s == "OK" for s in states)
    meas = {"frames": n, "tracked": tracked, "rmse_m": rmse, "n_kf": slam.n_kf,
            "kf_inserted": slam.kf_inserted, "n_mp": slam.n_mp,
            "rmse_final_poses_m": lap_errors(slam, poses[:n])[1],
            "fps": n / wall, "wall_s": wall, "fps_15b": node["fps"],
            **batch_lap_times(calls), **batch_lap_counts("17b", count, launches), "card": smi}
    meas["host_ms_per_tracking_dispatch"] = sum(calls) / meas["tracking_dispatches"]
    log(f"[rgbd batch] tracked {tracked}/{n} (JAX {ref['tracked']}), RMSE of the track-time twc "
        f"{rmse * 1e3:.2f} mm (JAX frame by frame {ref['rmse_m'] * 1e3:.2f}; of the final poses "
        f"{meas['rmse_final_poses_m'] * 1e3:.2f}), keyframes {slam.n_kf} (JAX {ref['n_kf']}); "
        f"{meas['fps']:.2f} frames/s (15b over TCP frame by frame {node['fps']:.2f}), batch ms "
        f"first {calls[0]:.1f}, p50 {meas['batch_ms_p50']:.1f}, max {meas['batch_ms_max']:.1f}, "
        f"host ms a tracking dispatch {meas['host_ms_per_tracking_dispatch']:.1f} (15b's round "
        f"trip p50 {node['latency']['p50_ms']:.1f}); calls {meas['calls']}; launches {launches}; "
        f"{smi}")
    if tracked < ref["tracked"] - NODE_TRACKED_MARGIN:
        raise AssertionError(f"17b: tracked {tracked} < {ref['tracked']} - {NODE_TRACKED_MARGIN}")
    if rmse > RMSE_FACTOR * ref["rmse_m"] + RMSE_SLACK_M:
        raise AssertionError(f"17b: RMSE {rmse:.5f} m > 2 x {ref['rmse_m']:.5f} + 2 mm")
    if abs(slam.n_kf - ref["n_kf"]) > NODE_RGBD_KF_MARGIN:
        raise AssertionError(f"17b: {slam.n_kf} keyframes, JAX {ref['n_kf']}")
    return launches, meas


def load_fixture(path: str, n_frames: int = N_FRAMES) -> dict:
    with open(path) as f:
        ref = json.load(f)
    if n_frames is not None and ref["frames"] != n_frames:
        raise AssertionError(f"{path}: {ref['frames']} frames, expected {n_frames}")
    return ref


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from orb_slam3_noted_tpu_torch.ops import cuda_kernels as ck

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    so, build_log = ck.build_library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log(f"[build]   {line.strip()}")

    ref_rgbd, ref_stereo = load_fixture(FIXTURE), load_fixture(STEREO_FIXTURE)
    ref_mono = load_fixture(MONO_FIXTURE, MONO_FRAMES)
    ref_stereo_batch = load_fixture(STEREO_BATCH_FIXTURE)
    ref_reloc = load_fixture(RELOC_FIXTURE, RELOC_FRAMES)
    ref_loop = load_fixture(LOOP_FIXTURE, LOOP_FRAMES)
    with open(CORRECTION_FIXTURE) as f:
        ref_corr = json.load(f)
    ref_si = load_fixture(SI_FIXTURE, SI_FRAMES)
    with open(FOURDOF_FIXTURE) as f:
        ref_4dof = json.load(f)
    ref_fe = load_fixture(FE_STEREO_FIXTURE, FE_FRAMES)
    ref_fe_vi = load_fixture(FE_INERTIAL_FIXTURE, FE_FRAMES)
    ref_atlas, ref_satlas, ref_iatlas = (load_fixture(p, None) for p in (
        ATLAS_FIXTURE, STEREO_ATLAS_FIXTURE, INERTIAL_ATLAS_FIXTURE))
    cfg = lap_config()
    t0 = time.perf_counter()
    poses, frames = lap_inputs(N_FRAMES)
    mono_poses, mono_imgs = mono_inputs()
    log(f"[lap] rendered {N_FRAMES} stereo pairs with depth and {MONO_FRAMES} mono frames in "
        f"{time.perf_counter() - t0:.1f} s")

    log("[kernels] kernel vs plain version on the card, lap frame 0")
    t_kernels = time.perf_counter()
    floor = check_launch_floor(dev)
    log(f"  launch floor: an empty kernel lasts {floor:.5f} ms on the device")
    kres = check_kernels(cfg, frames[0][0], frames[0][1], dev)
    kres["sad_stereo"] = check_sad(cfg, frames[0][0], frames[0][1], dev)
    kres["fast_score"] = check_dense_fast(cfg, frames[0][0], dev)
    log(f"[kernels] batch shapes: K1-K3 over the mono lap's first {BATCH} frames and over the "
        f"first {BATCH} stereo pairs' {2 * BATCH} images, K4 over those pairs")
    for name, r in check_batch_kernels(cfg, mono_imgs[:BATCH], [f[0] for f in frames[:BATCH]],
                                       [f[1] for f in frames[:BATCH]], dev).items():
        kres[name].update(r)
    for r in kres.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r["bytes"], r["ops"])
        # each kernel is one launch: it cannot end sooner than an empty one
        r["launch_floor_ms"] = floor
        r["bound_or_launch_floor_ms"] = max(r["bound_ms"], floor)
    log(f"[time] kernel phase: {time.perf_counter() - t_kernels:.1f} s, "
        f"{time.perf_counter() - t_start:.1f} s since the start")
    ms = lambda v: "none" if v is None else f"{v:.4f}"
    log("  times in ms: device (the kernels' own durations, torch.profiler) / per call "
        "(CUDA events around one call); K1-K3 one image's atlas")
    for name, r in kres.items():
        log(f"  {name:<15} mismatches {r['mismatches']:>4}  max_abs_err {r['max_abs_err']:.3g}  "
            f"kernel {ms(r['ms'])} / {ms(r['per_call_ms'])} (host {ms(r['host_ms'])})  "
            f"plain {ms(r['plain_ms'])} / {ms(r['plain_per_call_ms'])}  "
            f"library {ms(r['library_ms'])} / {ms(r.get('library_per_call_ms'))}  "
            f"bound {r['bound_ms']:.5f} ({r['bound_by']}), with the launch floor "
            f"{r['bound_or_launch_floor_ms']:.5f}")
        if "replaced_ms" in r:
            log(f"  {'':<15} the 8 dense launches and 8 PyTorch cell_candidates it replaces: "
                f"{ms(r['replaced_ms'])} / {ms(r['replaced_per_call_ms'])}, of which the dense "
                f"kernel {ms(r['dense_ms'])}")
        if "ms_pair" in r:
            log(f"  {'':<15} stereo pair (B=2): kernel {ms(r['ms_pair'])} / "
                f"{ms(r['per_call_ms_pair'])} (host {ms(r['host_ms_pair'])})")
        for b in (16, 32):
            if f"ms_b{b}" in r:
                t = {k[:-len(f"_b{b}")]: v for k, v in r.items() if k.endswith(f"_b{b}")}
                log(f"  {'':<15} B={b}: kernel {ms(t['ms'])} / {ms(t['per_call_ms'])} (host "
                    f"{ms(t['host_ms'])})  plain {ms(t['plain_ms'])} / "
                    f"{ms(t['plain_per_call_ms'])}  bound {t['bound_ms']:.5f} ({t['bound_by']})")

    # each lap with the counts set to 0 just before it and read just after;
    # then each kernel against its plain version on every input shape the
    # lap gave it
    by_lap, lap_err = {}, {}

    def lap(tag, run, *args):
        t0 = time.perf_counter()
        with KernelInputs() as kept:
            out = run(*args)
        lap_err[tag] = kept.check(tag)
        log(f"[time] {tag}: {time.perf_counter() - t0:.1f} s, {time.perf_counter() - t_start:.1f} "
            "s since the start")
        return out

    by_lap["rgbd_lap"] = lap("rgbd_lap", run_rgbd_lap, cfg, poses, frames, ref_rgbd, dev)
    by_lap["stereo_lap"] = lap("stereo_lap", run_stereo_lap, cfg, poses, frames, ref_stereo, dev)
    by_lap["mono_lap"], fps_mono = lap("mono_lap", run_mono_lap, mono_poses, mono_imgs,
                                       ref_mono, dev, smi)
    by_lap["stereo_batch_lap"], fps_sb = lap("stereo_batch_lap", run_stereo_batch_lap, cfg, poses,
                                             frames, ref_stereo_batch, dev, smi)
    by_lap["mono_reloc_lap"], reloc = lap("mono_reloc_lap", run_reloc_lap, ref_reloc, dev, smi)
    log(f"[laps] frames/s: mono {fps_mono:.2f} (process_batch, B={BATCH}, {MONO_FRAMES} frames), "
        f"stereo batch {fps_sb:.2f} ({N_FRAMES} pairs), kidnapped mono {reloc['fps']:.2f} "
        f"(process, {RELOC_FRAMES} frames); {smi}")
    log(f"[laps] kidnapped lap: {json.dumps(reloc)}")
    # phase 10: loop closing; 10a the first 200 frames of bench.py's 400-frame
    # loop lap in both arms, and the wide arm's 400
    # (each arm its own count), 10b a full-width loop correction
    loop = {}
    for arm in ("loop_off", "loop_on", "loop_wide"):
        by_lap[f"mono_loop_lap_{arm[5:]}"], loop[arm] = lap(
            f"mono_loop_lap_{arm[5:]}", run_loop_lap, ref_loop, dev, smi, arm)
    log(json.dumps(loop_metric_line(loop["loop_off"], loop["loop_on"])))
    log(f"[laps] loop lap: {json.dumps(loop)}")
    by_lap["loop_correction"], corr = lap("loop_correction", run_loop_correction, ref_corr, dev,
                                          smi)
    log(f"[laps] loop correction: {json.dumps(corr)}")
    # phase 11: visual-inertial SLAM; 11a bench.py's stereo-inertial lap,
    # 11b one 4-DoF loop correction at full width
    t0 = time.perf_counter()
    si_in = si_inputs(ref_si)
    log(f"[si] rendered {len(si_in[2])} stereo pairs in {time.perf_counter() - t0:.1f} s")
    by_lap["stereo_inertial_lap"], si = lap("stereo_inertial_lap", run_si_lap, ref_si, si_in, dev,
                                            smi)
    log(json.dumps(si_metric_line(si)))
    log(f"[laps] stereo-inertial lap: {json.dumps(si)}")
    by_lap["loop_4dof"], four = lap("loop_4dof", run_4dof, ref_4dof, dev, smi)
    log(f"[laps] 4-DoF correction: {json.dumps(four)}")
    # phase 12: fisheye stereo at TUM-VI's 512x512; 12a FisheyeStereoSLAM,
    # 12b FisheyeStereoInertialSLAM on the same pairs, 12c K1-K3 on frame 0's
    # pair against their plain versions
    t0 = time.perf_counter()
    fe_inputs = fisheye_inputs(ref_fe)
    log(f"[fisheye] rendered {len(fe_inputs[1])} fisheye pairs in "
        f"{time.perf_counter() - t0:.1f} s")
    by_lap["fisheye_lap"], fe = lap("fisheye_lap", run_fisheye_lap, ref_fe, fe_inputs, dev, smi)
    log(f"[laps] fisheye lap: {json.dumps(fe)}")
    by_lap["fisheye_inertial_lap"], fe_vi = lap("fisheye_inertial_lap", run_fisheye_vi_lap,
                                                ref_fe_vi, fe_inputs, dev, smi)
    log(f"[laps] fisheye stereo-inertial lap: {json.dumps(fe_vi)}")
    log("[kernels] K1-K3 over the atlas of the fisheye lap's frame 0 pair (B = 2, 512x512)")
    for name, r in check_fisheye_kernels(ref_fe, fe_inputs[1][0], dev).items():
        kres[name].update(r)
        t = {k[:-len("_fisheye_pair")]: v for k, v in r.items() if k.endswith("_fisheye_pair")}
        log(f"  {name:<15} kernel {ms(t['ms'])} / {ms(t['per_call_ms'])} (host "
            f"{ms(t['host_ms'])})  plain {ms(t['plain_ms'])} / {ms(t['plain_per_call_ms'])}  "
            f"library {ms(t.get('library_ms'))} / {ms(t.get('library_per_call_ms'))}  bound "
            f"{t['bound_ms']:.5f} ({t['bound_by']}); {smi}")
    # phase 13: the Atlas; 13a the kidnapped monocular lap with a switch and
    # a merge (13d its checkpoint, restored), 13b the stereo multi-session,
    # 13c the inertial Atlas
    by_lap["atlas_lap"], atl = lap("atlas_lap", run_atlas_lap, ref_atlas, dev, smi)
    log(f"[laps] atlas lap: {json.dumps(atl, default=float)}")
    by_lap["stereo_atlas_lap"], satl = lap("stereo_atlas_lap", run_stereo_atlas_lap, ref_satlas,
                                           dev, smi)
    log(f"[laps] stereo multi-session: {json.dumps(satl, default=float)}")
    by_lap["inertial_atlas_lap"], iatl = lap("inertial_atlas_lap", run_inertial_atlas_lap,
                                             ref_iatlas, dev, smi)
    log(f"[laps] inertial atlas lap: {json.dumps(iatl, default=float)}")
    # phase 14: the CLI on dataset layouts; 14a EuRoC stereo-inertial
    # (rectified on the card), 14b TUM RGB-D, 14c TUM-VI fisheye-inertial
    # 14a and 14c lay out the first pairs that phases 11 and 12 rendered
    L = _cli_layouts()
    same = lambda a, b, n: all(np.array_equal(x[:n], y[:n]) for x, y in
                               zip(L.stored_poses(a, n), L.stored_poses(b, n)))
    if not same(ref_fe, ref_fe_vi, L.TUMVI_FRAMES):
        raise AssertionError("the fisheye fixtures' poses differ: 14c cannot reuse 12's pairs")
    rendered = {"cli_euroc": si_in[2], "cli_tum_rgbd": None, "cli_tumvi": fe_inputs[1]}
    cli_meas = {}
    for name in CLI_LAYOUTS:
        by_lap[name], cli_meas[name] = lap(name, run_cli_layout, name,
                                           load_fixture(os.path.join(
                                               ROOT, "tests", "fixtures", f"{name}.json"), None),
                                           ref_si, ref_fe_vi, dev, smi, rendered[name])
        log(f"[laps] {name}: {json.dumps(cli_meas[name], default=float)}")
    # phase 15: the live node and the viewer; 15a the stereo-inertial node
    # (phase 11's first pairs and IMU), 15b the RGB-D node with the viewer
    # (phase 4's frames), 15c the stereo node at camera rate (phase 5's pairs)
    ref_node_si = load_fixture(NODE_SI_FIXTURE, NODE_SI_FRAMES)
    ref_node_rgbd = load_fixture(NODE_RGBD_FIXTURE)
    node_meas = {}
    by_lap["node_stereo_inertial"], node_meas["15a"] = lap(
        "node_stereo_inertial", run_node_si, ref_node_si, ref_si, si_in, dev, smi)
    by_lap["node_rgbd"], node_meas["15b"] = lap(
        "node_rgbd", run_node_rgbd, ref_node_rgbd, cfg, poses, frames, dev, smi)
    by_lap["node_stereo_realtime"], node_meas["15c"] = lap(
        "node_stereo_realtime", run_node_realtime, cfg, [(f[0], f[1]) for f in frames], dev, smi)
    log(f"[laps] live node: {json.dumps(node_meas, default=float)}")
    # phase 16: distribution; 16a the full-capacity GBA and 16b the
    # 256-keyframe pose graph on a one-rank NCCL group and on two ranks
    # sharing the card over gloo, 16c the loop closer in that 2-rank group
    dist_meas = run_distribution(ref_corr, dev, smi)
    log(f"[time] distribution: {dist_meas['seconds']:.1f} s, {time.perf_counter() - t_start:.1f} "
        "s since the start")
    # phase 17: the batch modes of RGB-D and fisheye stereo at B = 16; 17a
    # phase 12's pairs, 17b phase 4's frames and depth maps
    batch_meas = {}
    by_lap["fisheye_batch_lap"], batch_meas["17a"] = lap(
        "fisheye_batch_lap", run_fisheye_batch_lap, ref_fe, fe_inputs, fe, dev, smi)
    by_lap["rgbd_batch_lap"], batch_meas["17b"] = lap(
        "rgbd_batch_lap", run_rgbd_batch_lap, ref_node_rgbd, cfg, poses, frames,
        node_meas["15b"], dev, smi)
    log(f"[laps] batch modes: {json.dumps(batch_meas, default=float)}")
    for name in COMPARE:
        errs = [e[name] for e in lap_err.values() if name in e]
        kres[name]["max_abs_err_laps"] = max(errs)
        # `max_abs_err`: the largest of every check (B = 1, 2, 16, 32, the laps)
        kres[name]["max_abs_err"] = max(v for k, v in kres[name].items()
                                        if k.startswith("max_abs_err"))

    # `launches` adds up every lap's; `ms`, `plain_ms` and `library_ms` are
    # device times; every other time the kernel phase measured rides along
    # under its own key (``_pair``: B = 2, ``_b16``: B = 16).
    timed = lambda r: {k: v for k, v in r.items()
                       if k == "ms" or k.endswith("_ms") or "ms_" in k or k.startswith("bound_by")
                       or k.startswith("max_abs_err")}
    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1],
            "launches": sum(lap[name] for lap in by_lap.values()),
            "launches_by_lap": {k: lap[name] for k, lap in by_lap.items()},
            **timed(kres[name]),
        }
        for name in KERNEL_SOURCES
    ]
    if EVENT_TIMED:
        log(f"[timing] device times taken with CUDA events, not the profiler: {EVENT_TIMED}")
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_pool()
    sys.exit(rc)
