#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
  1. device: a CUDA card is required; prints its name and power limit.
  2. build: compiles every CUDA kernel of the main path from csrc/.
  3. kernels: each kernel against its plain torch version at the main
     path's shapes: the level kernel at all 4 levels of a rendered
     752x480 pair (N=150, features near the borders, guesses that hit
     the window clamp), the track kernel on the slice's temporal pair
     (frames 10 -> 11) and stereo pair (frame 11 left -> right) with the
     same border tail, and the track kernel at radius 8 on the instance
     tracker's input (the dynamic scene's frames 10 -> 11, K*N = 400
     rows, a third of them valid: corners inside the eroded object
     masks; 3 levels, fb 1.0 px, border 3); then CUDA-event timings of
     kernel, wrapper and plain version, and each kernel's bound.
  4. slice: the RAW stereo+IMU System on 30 rendered 752x480 frames
     (seed 0, 20 Hz camera, 200 Hz IMU with noise, 300 landmarks,
     VioConfig defaults, estimator in float32; landmark blobs of sigma
     3.2 px, the 1.6 px of the 376x240 tests scaled to this resolution,
     see PERF.md) on its default path: once the window is full, each
     frame's backend is one replay of the megastep's CUDA graph chain.
     Counts kernel launches (one track launch per track, two a frame, and
     no per-level launch) and step replays (one a steady frame), checks
     features, finiteness and the unaligned ATE gate, and prints
     steady-state ms/frame, stage means and peak device memory; then
     times the megastep eager against its replay, per branch.
  5. graph check: in float64 at the slice's widths (window 11, 512
     landmark slots, 4096 obs rows) on the scene's 30 feature-domain
     frames, the estimator alone as tests/test_pipelined.py runs it: the
     pipelined outputs within 2e-2 m of the sequential ones
     (test_pipelined.py's bound), and a replay of each branch's chain
     (keyframe, non-keyframe) equal to the eager step on the same
     inputs, for both steps: masks identical, positions within 1e-6 m.
  6. pipelined: the slice with `VioConfig.pipelined` (frontend two
     frames ahead, device-resident steady state): the same counts and
     gate; its distance to the sequential phase is printed, not gated:
     in float32 two runs of this scene part by centimetres (the card's
     atomic sums differ from run to run, and the scene amplifies
     rounding, see PERF.md), so phase 5 holds the bound in float64.
  7. multi-dispatch: the slice's first 15 frames on the multi-dispatch
     estimator path (`use_megastep = False`): the same launch count and
     gate, and no replay.
  8. naive: the slice's first 15 frames in NAIVE mode with a fixed
     rectangular `dynamic_mask`: no tracked point inside it, the same
     launch counts and gate.
  9. dynamic: the DYNAMIC System (VioConfig defaults with slam=dynamic:
     window 10, max_cnt 150, 50 features an instance, 8 instance slots,
     32 landmarks and 512 observations an object) on 30 frames of the
     slice's scene with 3 moving textured boxes (the port's
     sim/dynamic_scene: instance masks, disparity, 3D boxes). Gates: the
     radius-8 track kernel launched twice on every frame with instances
     (temporal and stereo) and the radius-10 one twice a frame, no
     level launch and no plain LK; one megastep replay every steady
     frame and at most one object-solve replay a frame; ego ATE < 0.25
     m and an instance within 2.0 m of an object's truth (the gates of
     tests/test_dynamic_rendered.py); a non-empty KITTI-MOT file. Prints
     ms/frame, stage means, peak memory, and the object solve eager
     against its replay.
 10. naive-pipelined: phase 8 with `VioConfig.pipelined`: no tracked
     point inside the rectangle, two track launches a frame, one
     pipelined-step replay every steady frame.
 11. dynamic-pipelined: phase 9 with `VioConfig.pipelined` and its
     gates; also every input frame has an output once drained, in
     order, and one pipelined-step replay every steady frame. Prints
     its ms/frame beside phase 9's.
 12. cli: the slice's scene written as an EuRoC tree (cam0/cam1 CSV and
     PNGs through the port's encoder, imu0, ground truth, a text
     config) and run through `run.main(["--dataset", "euroc", ...])` in
     this process; then the dynamic scene as a KITTI tracking tree
     (PNGs, SOLO `.pt` tensors, FCOS3D txt, 16-bit disparity PNGs,
     ground-truth labels) run with `--slam dynamic` (no IMU). Gates: the
     decoded images equal the written bytes (and the disparity and
     segmentation read back equal), launch and replay counts as in
     phases 4 and 9, aligned ATE < 0.20 m, a non-empty MOT file. Prints
     the decode ms a frame and CLEAR-MOT against the labels (MOTA, ID
     switches, track ids). The CLI's estimator runs in float32 (the
     System's default on the card). Last, the EuRoC tree again with a
     config that sets `is_stereo: 0` (mono+IMU): one track launch a
     frame, one replay a steady frame, initialized, finite poses.
 13. mono: the slice's scene (seed 0, 20 Hz camera, 200 Hz IMU with
     noise, VioConfig defaults with `is_stereo` off, estimator in
     float32) through the System on the megastep, from frame 0 until
     15 steady frames after the frame on which the mono initialization
     (essential matrix, SfM, visual-inertial alignment) succeeded; it
     must succeed by frame 14. Gates: the track kernel launched once a
     frame (the temporal track only), no level launch and no plain LK;
     one megastep replay every steady frame; initialized and not failed;
     on the frames from initialization + 10 on, the trajectory's shape:
     ATE after a similarity alignment < 0.10 m. The metric scale is
     printed, not gated: on this scene the reference's own mono
     initialization gives a trajectory about 6x too short (the JAX
     System on the CPU: scale 6.31, ATE aligned without scale 0.289 m;
     PERF.md), which the window's BA corrects only over ~100 frames at
     20 Hz. The reference's metric gates (tests/test_mono_vio.py: ATE
     aligned without scale < 0.10 m, Umeyama scale within 5% of 1, on
     frames 25-39) are then held on that test's own protocol: the
     estimator alone in float64 on its 40 feature-domain mono frames
     (10 Hz, seed 0, 0.5 px, window 11) on the megastep. Prints the
     frame it initialized on, the initialization's host ms, ms/frame and
     stage means over the steady frames after the one that captures the
     graphs, and peak memory.
 14. resume: in float64 at the slice's widths on the scene's
     feature-domain frames (as phase 5), the estimator runs 20 frames,
     saves a checkpoint, and a fresh estimator on the megastep loads it
     and runs the last 10: their positions within 1e-6 m of the
     uninterrupted run's, and both runs replay the graphs (one replay a
     steady frame); then the same checkpoint loaded into the
     uninterrupted estimator, whose graphs were captured long before,
     runs the last 10 again within the same bound, which shows a loaded
     state reaches the captured graphs' buffers.
 15. linepoint: points + lines (`VioConfig.use_line`). The slice's
     scene with 50 world segments 2 m long (centred on
     `make_landmarks(50, seed=9)`, as tests/test_line_e2e.py draws its
     40) drawn into both images as bright
     antialiased strokes 2 px wide, their brightness (45-255) varying
     along each segment (`draw_strokes`: the tracker's descriptor is the
     intensity profile along a segment, which a uniform stroke leaves
     flat); this script's own raster, the card's machine has no cv2.
     30 frames on the megastep, estimator in float32. Gates: at least 10
     segments detected in every left image (the port's LSD, equal to
     OpenCV's, on the host: stage `fe.lsd`); from frame 1 on, on average
     at least half of a frame's segments carry an id of the frame
     before, and in every frame at least half do counting the other edge
     of a segment's stroke (`carried_share`: LSD returns both edges of a
     stroke, and the reference's greedy matcher carries the second only
     by chance); at least 5 lines with a valid orth at the end, 60% of them within cos
     0.99 of the direction of the world segment their newest left
     observation lies on (tests/test_line_e2e.py:91-104); unaligned ATE
     < 0.20 m; the track kernel launched twice a frame, no level launch
     and no plain LK; one megastep replay every steady frame and 3 host
     syncs a replay. Then 15 frames with `VioConfig.pipelined`: an
     output for every frame once drained, in order, one pipelined-step
     replay every steady frame. Then, in float64 at the slice's widths
     on the scene's feature-domain frames with the segments' projected
     endpoints (0.3 px noise), a replay of each branch of both steps
     equal to the eager step: masks identical, positions and line orth
     within 1e-6. Prints ms/frame, stage means with `fe.lsd`, segments a
     frame, peak memory, the replays' segments and host syncs.
 16. nets: the five online perception nets on the card at 752x480, each
     through `models.pretrained.load_online` with the shipped weights
     and the manifest's hyperparameters (SOLOv2: 8 classes, grids
     12/8/6/4; FCOS3D: 6 classes; stereo, max_disp 128; RAFT, 8
     updates; ReID), and again on the CPU with the same weights and
     inputs (the slice's frame 10 left image; its stereo pair; frames
     10 -> 11 for RAFT; 16 boxes of frame 10, clamped crops, for ReID).
     The raw head outputs (SOLOv2's kernels, category scores and mask
     features; FCOS3D's three maps a level; the disparity; the flow;
     the embeddings) agree within 1e-3 of each output's scale, the
     disparity and flow within 0.1 px. Prints each net's ms a call
     (CUDA events, 20 calls after 5 warm-up; the wrapper's device path,
     the image upload included), its peak device memory above what was
     held before its calls, and the card's name and power limit. TF32 stays off for cuDNN and matmuls.
 17. accuracy: the shipped stereo net (max_disp 32), RAFT (4 updates)
     and ReID on the card, on fresh batches from the port's copies of
     the generators at 96x128 (seed 123, the batch that
     tests/test_shipped_weights.py scores; ReID seed 7, 4 ids x 4
     views): stereo smooth-L1 EPE < 2.5 px, flow EPE < 9.0 px, ReID
     mean intra-class minus inter-class cosine > 0.25 (that test's
     gates). The only check of the nets' trained behaviour on the card.
 18. online: the DYNAMIC System, stereo+IMU, with every net online
     (`det2d_online`, `det3d_online`, `stereo_online`, `use_dense_flow`,
     `use_reid`) on the 30 frames of phase 9's scene with no offline
     artifact: stereo, RAFT and ReID with the shipped weights, SOLOv2
     and FCOS3D seeded at the System's default shapes (80 and 10
     classes; the manifest's are not those), the SOLOv2 score threshold
     0 (as tests/test_system.py runs its untrained detector). Gates: an
     output for every frame, finite states and instance states, every
     net called on every steady frame where the JAX System calls it
     (SOLOv2, FCOS3D, stereo every frame; RAFT from the second frame
     on; ReID on frames with a dynamic-class detection), the radius-10
     track kernel launched for the stereo track every frame and for the
     temporal track on frame 0 only (the flow field replaces it after),
     the radius-8 one twice on every frame with instances, no level
     launch and no plain LK. Prints ms/frame, the perception stage and
     its per-net split, `fe.dispatch`, `be.step`, the ego ATE (not
     gated: the untrained detector's instances), peak memory.
 19. loop: loop closure (`use_loop_closure`; ORB keyframes, PnP loop
     edges, the pose-graph solve, the live correction), estimator in
     float32. (a) The RAW stereo+IMU System at 752x480 (VioConfig
     defaults, keyframe stride 5, loop_min_gap 12, loop_prox_radius 4 m,
     LoopClosureConfig defaults) on a circular lap around
     tests/test_loop_live.py's landmark cloud (300 landmarks, seed 3,
     radius 6 m, blob sigma 3.2 px) at 10 Hz, 75 frames a lap, so frame
     75 (keyframe 15) revisits frame 0 exactly; 90 frames with stereo
     images, disparity from the renderer's depth and 200 Hz IMU with
     noise, once with the live correction and once without. Gates: a
     loop edge with j - i >= 12; finite outputs, one trajectory row a
     frame in order; the live run's final position error below the
     uncorrected run's; the loop file's rows are the keyframes; the
     track kernel twice a frame, no level launch, no plain LK; one
     replay a steady frame, one capture a branch (the correction's
     re-prime captures nothing new). Prints the edges, the frame each
     correction landed on, the loop stage's ms a keyframe (mean, max),
     ORB ms a keyframe and the pose-graph solve ms at the final K (CUDA
     events), ms/frame, peak memory. (b) (a) with `VioConfig.pipelined`
     and the live correction: a loop edge, and the trajectory holds
     every frame once in order, the frames the correction drains
     included. (c) The pose graph at the database's capacity: 512 nodes
     on two laps of a 20 m ring, drifted odometry and 8 exact loop
     edges, weighted as the loop closer weighs them: the cost falls, the
     card's float64 solve (the loop closer's float type) lands within
     1e-3 m of the CPU's; the card's float32 solve's distance is
     printed, not gated (0.43 m on the H100: why the loop closer solves
     in float64); prints the solve and build-normal-equations ms (CUDA
     events) and peak memory of both. (d)
     tests/test_loop_live.py's protocol (376x240, 220 landmarks, blob
     sigma 1.6 px, a 36-frame lap at 2.57 Hz, 45 frames, window 7,
     max_cnt 120, min_dist 12, stride 2) with the live correction and
     without, the estimator in float64 as that test runs it, then in
     float32: an edge, and the live run at least 2x closer to the truth
     than the uncorrected one on the first frame after the first
     correction. That test gates the last frame instead, and that gate
     does not hold here: its numbers are printed (float64 on the H100:
     1.3433 m live, 0.5395 m uncorrected). The card's run equals the
     port's on the CPU with the track kernel's LK semantics, and with
     the CPU's Scharr/gather LK form the card meets the gate as the CPU
     does (1.0930 against 3.2336 m); tests/loop_live_witness.py runs
     either System with either form (PERF.md).
 20. training: the perception nets' training on the card (autograd over
     the port's modules, the optax-equal AdamW of `training/trainer`),
     nothing on the CPU. (a) tests/test_training.py's five protocols at
     their sizes, steps and learning rates from the port's seeded init:
     stereo (48x64, max_disp 16) below 0.5x its first loss after 40
     steps, flow (RAFT, 3 updates) below 0.8x after 25, SOLOv2 and FCOS3D
     (96x128) below 0.7x after 20, ReID (embeddings of 32) inter- minus
     intra-class cosine distance > 0.1 after 40. (b) Each of the five
     training-CLI tasks (`training/cli.build_task`: its models and the
     manifest's model kwargs) at 96x128 and its `RECIPES` batch (solo 4,
     det3d 4, stereo 4, flow 2, ReID 16) for 30 steps on fresh batches
     from `next_batch` (made before the timing): ms a step (CUDA events
     over steps 10-29), peak device memory, first and last loss; every
     loss finite. (c) `tools.train_shipped_weights` into output/: stereo
     at its full recipe (700 steps), the other four at scale 0.02; each
     file loads back through `load_online(params_path=...)` and runs;
     the retrained stereo net meets phase 17's gate (< 2.5 px on its
     batch) and < 0.5x the untrained net's loss. (d) The SOLOv2 and
     FCOS3D gates of tests/test_shipped_weights.py:52-61 on the shipped
     weights with the port's losses on that test's batch: SOLOv2 < 1.6
     and < 0.6x the untrained loss, FCOS3D < 4.0 and < 0.7x. (e)
     `tools.precompute` over phase 12's KITTI tree (5 frames, tasks seg,
     det3d, disp, flow): every artifact read back with the port's
     readers; ms a frame, twice (the first run builds cuDNN's plans).
     `dynamic_vins_tpu/weights/` is unchanged after the phase.
 21. tools: the bench-side tools on the card. (a) `tools.accuracy_probe`
     (the bench protocol: 42 frames, window 11, 512 slots, 8192 rows,
     0.5 px, pipelined) for seeds 0-2 in float32 and float64; the port's
     own `--platform cpu --x64 --seeds 1` runs in a subprocess started
     at phase 20 (4 threads, nice 19; no main-path phase runs beside
     it) and is read here: the card's float64 seed 0 within 1e-4 m of
     its line; float32 minus float64 printed. (b) `tools.dynamic_bench`
     with its defaults (40 frames, 2 objects, window 11): every number
     finite; its JSON printed. (c) `tools.singlechip_scaling --fast`:
     every final cost finite; the batched windows (`vmap` of the LM, one
     CUDA graph) in float64 within 1e-4 of the B = 1 row's and of the
     unbatched solve's state; the timed float32 rows within 1e-3 of
     B = 1, of the unbatched solve and of the float64 solve of the same
     inputs (the unbatched float32 solve's own distance from that
     float64 solve printed beside them: float32's rounding, PERF.md);
     the table printed. (d), which runs first (its times are CUDA
     events, and the CPU probe ends meanwhile): `tools.build_engines`
     for the five stages at 480x752
     into build/engines: each exported program against its live function
     on phase 16's inputs within 1e-4 of the output's scale; bytes,
     export s, and engine and live ms a call. (e) The RAW slice (30
     frames, as phase 4, its `lk_track` launches counted in the kernels
     line) records the frames its estimator receives with
     `io.feature_serialization.FeatureRecorder`; a fresh float32
     estimator replays the file: the largest position difference from
     the live run's outputs within 1e-5 m, and whether it was exact.
     Both runs sum in a fixed order (`torch.use_deterministic_algorithms`
     for this sub-phase): with the card's atomic `index_add_` two
     replays of one file part by centimetres in float32 (PERF.md). (f)
     `io.native_loader.PrefetchLoader` (4 workers) over phase 12's 60
     EuRoC PNGs: in order, every frame equal to sequential
     `decode_image` and to `image_io`'s grey decode; ms a frame of
     both. (g) The equidistant, MEI and Scaramuzza models: pixel -> ray
     -> pixel over the 752x480 grid in float64 (within 1e-5 px) and
     float32 (1e-3 px) on the card, beside the CPU's;
     `geometry.calibration.calibrate_planar` on tests/test_calibration.py's
     views on the card within 1e-8 of the CPU's result.
A capture or replay that fails raises and ends the run (nothing falls
back to eager execution). Prints one JSON line describing the kernels,
then, last, the result line {"ok": true, "device": {...}}.

Imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
START = time.perf_counter()    # the script's clock (`stamp`)
SEED = 0
FRAMES = 30
MULTI_FRAMES = 15          # the multi-dispatch phase's depth
STEADY_FROM = 15
N_FEAT = 150
N_LANDMARKS = 300
# EuRoC's camera rate; it also gives the pixel motion per frame of the
# 376x240 tests at 10 Hz (see PERF.md)
FRAME_HZ = 20.0
ATE_GATE_M = 0.20
# landmark blob sigma: the renderer's 1.6 px default is sized for the
# 376x240 rig of the tests; at 752x480 the same scene has 3.2 px blobs
BLOB_SIGMA_PX = 3.2
FLOW_ATOL_PX = 1e-3
REPLAY_POS_ATOL_M = 1e-6   # float64 replay against the eager step
PIPE_POS_ATOL_M = 2e-2     # pipelined against sequential
                           # (tests/test_pipelined.py:48)
# H100 SXM published peaks (700 W): HBM bytes/s, float32 non-tensor flop/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
LK_TPU_KERNEL = "dynamic_vins_tpu/ops/lk_pallas.py:133"
N_OBJECTS = 3
NAIVE_FRAMES = 15          # the NAIVE phase's depth
DYN_ATE_GATE_M = 0.25      # tests/test_dynamic_rendered.py:95
DYN_OBJ_GATE_M = 2.0       # tests/test_dynamic_rendered.py:113
MONO_STEADY = 15           # steady frames after the mono initialization
MONO_ATE_GATE_M = 0.10     # tests/test_mono_vio.py:39-40, aligned
MONO_SCALE_TOL = 0.05      # tests/test_mono_vio.py:43-45, Umeyama scale
MONO_REF_FRAMES = 40       # tests/test_mono_vio.py's protocol
MONO_REF_FROM = 25
RESUME_AT = 20             # phase 14 checkpoints after this many frames
N_SEGMENTS = 50            # world segments (tests/test_line_e2e.py: 40)
LINE_PIPE_FRAMES = 15      # the pipelined LinePoint run's depth
LINE_CHECK_FRAMES = 20     # the float64 LinePoint replay check's depth
MIN_SEGMENTS = 10          # segments a left image
MIN_LINES = 5              # tests/test_line_e2e.py:88
LINE_COS = 0.99            # tests/test_line_e2e.py:100-104
NET_RTOL = 1e-3            # nets: card vs CPU, relative to the output's scale
NET_PX_ATOL = 0.1          # nets: card vs CPU, disparity and flow (px)
ACC_HW = (96, 128)         # tests/test_shipped_weights.py
ACC_SEED = 123
ACC_STEREO_PX = 2.5        # tests/test_shipped_weights.py:43
ACC_FLOW_PX = 9.0          # tests/test_shipped_weights.py:49
ACC_REID_SEP = 0.25        # tests/test_shipped_weights.py:79
ONLINE_DET2D_THRESH = 0.0  # tests/test_system.py:214 (an untrained head)
ONLINE_SEEDS = 16          # SOLOv2 seeds tried for a dynamic-class instance
LOOP_LAP = 75              # phase 19: frame 75 revisits frame 0 exactly
LOOP_FRAMES = 90
LOOP_HZ = 10.0             # the reference's design rate
LOOP_STRIDE = 5            # keyframe stride: keyframe 15 is frame 75
LOOP_MIN_GAP = 12          # keyframe 15 may query keyframes 0-2
LOOP_PROX_M = 4.0
LOOP_RADIUS_M = 6.0        # tests/test_loop_live.py's circle
LOOP_HEIGHT_M = 0.3
LOOP_SEED = 3
LOOP_REF_FRAMES = 45       # tests/test_loop_live.py's protocol
LOOP_REF_LAP = 36
LOOP_REF_PERIOD = 14.0
LOOP_REF_GAIN = 2.0        # its gate: the live run at least 2x closer
PGO_NODES = 512            # LoopClosureConfig.max_keyframes
PGO_LOOPS = 8
PGO_ATOL_M = 1e-3          # card against CPU, float64 both
GRAVITY = 9.81
TRAIN_HW = (96, 128)       # the training CLI's default size
TRAIN_STEPS = 30           # phase 20b, on fresh batches
TRAIN_TIMED_FROM = 10      # 20b's CUDA-event window: steps 10-29
RETRAIN_SCALE = 0.02       # 20c: the four tasks other than stereo
SHIPPED_GATES = {"solo": (1.6, 0.6),      # tests/test_shipped_weights.py
                 "det3d": (4.0, 0.7)}     # :52-61 (loss, x untrained)
PRE_FRAMES = 5             # 20e: frames of phase 12's KITTI tree
PROBE_CPU_THREADS = 4      # 21a: the CPU probe's threads (the card's host
PROBE_CPU_TIMEOUT_S = 600  # has 8 cores); 21a waits at most this long
PROBE_ATOL_M = 1e-4        # 21a: card float64 seed 0 against the CPU's
BATCH_ATOL = 1e-4          # 21c: a batched window's state against B = 1's
                           # and the unbatched solve's, float64
BATCH_F32_ATOL = 1e-3      # 21c: the same and against the float64 solve,
                           # float32 (PERF.md: float32's own rounding)
ENGINE_RTOL = 1e-4         # 21d: engine against live, of the output's scale
REPLAY_ATOL_M = 1e-5       # 21e: replayed positions against the live run
LOADER_WORKERS = 4         # 21f
CAM_F64_PX = 1e-5          # 21g: grid roundtrip, float64 (tests/test_lie.py)
CAM_F32_PX = 1e-3          # 21g: float32
CALIB_ATOL = 1e-8          # 21g: calibrate_planar, card against CPU


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    if not (REPO / "dynamic_vins_tpu_torch").is_dir():
        fail(f"no dynamic_vins_tpu_torch package next to {__file__}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return card


def build_phase():
    from dynamic_vins_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.build("lk_level", force=True)
    print(f"build lk_level: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in build.build_logs.get("lk_level", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    # the host line detector of LinePoint (C++, host compiler)
    t0 = time.perf_counter()
    build.build("lsd", force=True)
    print(f"build lsd (host): {time.perf_counter() - t0:.2f} s", flush=True)


def make_scene(torch, dev, sigma=BLOB_SIGMA_PX, landmarks=N_LANDMARKS,
               frame_hz=FRAME_HZ):
    """The slice's sequence, its rendered stereo frames (numpy) and its
    per-frame IMU intervals."""
    from dynamic_vins_tpu_torch.sim import frontend_sim, render
    from dynamic_vins_tpu_torch.sim import synthetic as sim

    seq = sim.generate_sequence(num_frames=FRAMES, frame_hz=frame_hz,
                                imu_hz=200.0,
                                acc_noise=0.05, gyr_noise=0.005,
                                num_landmarks=landmarks, seed=SEED)
    inten = render.make_intensities(landmarks, seed=SEED)
    rig = seq.rig.to(dev)
    lms = seq.landmarks.to(dev)
    imgs = []
    for k in range(FRAMES):
        p, q = seq.gt_p[k].to(dev), seq.gt_q[k].to(dev)
        imgs.append(tuple(
            render.render_frame(rig, p, q, lms, inten, cam=c, sigma=sigma)
            .cpu().numpy() for c in (0, 1)))
    return seq, imgs, frontend_sim.imu_intervals(seq)


def _timed(torch, fn, reps):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _mark_patch(mask, oy, ox, ly, lx, P):
    """Mark in mask [H,W] the input pixels that bilinear P x P patches at
    window-local top-left (ly, lx) of the windows at (oy, ox) read: the
    (P+1)^2 taps inside the window, with the padded image's edge copies
    mapped back to the input's edge pixels."""
    import torch

    from dynamic_vins_tpu_torch.ops.lk_level import WIN_H, WIN_W

    H, W = mask.shape
    ar = torch.arange(P + 1, device=mask.device)
    r = torch.floor(ly).long()[:, None] + ar
    c = torch.floor(lx).long()[:, None] + ar
    rows = (oy.long()[:, None] + r.clamp(0, WIN_H - 1)).clamp_max(H - 1)
    cols = (ox.long()[:, None] + c.clamp(0, WIN_W - 1)).clamp_max(W - 1)
    inwin = (((r >= 0) & (r < WIN_H))[:, :, None]
             & ((c >= 0) & (c < WIN_W))[:, None, :])
    mask.view(-1)[(rows[:, :, None] * W + cols[:, None, :])[inwin]] = True


def lk_bytes(a, b, p, g, radius, iters):
    """Bytes one LK level must move on these inputs: the distinct img0
    pixels its template and +-1 px gradient patches read, the distinct
    img1 pixels its patches read over all `iters` iterations (each at
    the flow the iteration starts from, window clamp included), once
    each, plus pts and guess in and flow and ok out."""
    import torch

    from dynamic_vins_tpu_torch.ops import lk_level as K

    P = 2 * radius + 1
    _, _, meta = K.prepare(a, b, p, g)
    oy0, ox0, oy1, ox1 = meta.unbind(dim=1)
    x, y = p[:, 0], p[:, 1]
    m0 = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    tl_y = (y - oy0.to(y.dtype)) - radius
    tl_x = (x - ox0.to(x.dtype)) - radius
    for dy, dx in ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)):
        _mark_patch(m0, oy0, ox0, tl_y + dy, tl_x + dx, P)
    m1 = torch.zeros_like(m0)
    for it in range(iters):
        f = K.lk_level_plain(a, b, p, g, radius, it)[0]
        l1y = torch.clamp(((y + f[:, 1]) - oy1.to(y.dtype)) - radius, 0.0,
                          K.WIN_H - P - 2.0)
        l1x = torch.clamp(((x + f[:, 0]) - ox1.to(x.dtype)) - radius, 0.0,
                          K.WIN_W - P - 2.0)
        _mark_patch(m1, oy1, ox1, l1y, l1x, P)
    n = p.shape[0]
    return 4 * int(m0.sum() + m1.sum()) + 3 * n * 8 + n


def lk_bound_ms(nbytes, n, radius, iters):
    """(bytes time, operations time) of one level, ms: `nbytes` at peak
    HBM rate; the flops of the bilinear samples and reductions at
    float32 non-tensor peak. The bound is the larger."""
    P2 = (2 * radius + 1) ** 2
    sample = 11                      # 3 lerps + the two (1 - f) terms
    flops = n * P2 * (5 * sample + 4 + 6 + iters * (sample + 5))
    return 1e3 * nbytes / PEAK_BYTES_S, 1e3 * flops / PEAK_F32_FLOPS


def track_bound(pyr0, pyr1, pts, valid, fb_levels, radius=10, iters=10):
    """(bound ms, bound_by) of one track: the sum of the bounds of its
    level launches, each from lk_bytes / lk_bound_ms at the points and
    guesses the plain track gives that level (every row: the kernel
    tracks the invalid rows too)."""
    from dynamic_vins_tpu_torch.ops import lk_level as K

    calls = []

    def level(a, b, p, g):
        calls.append((a, b, p.contiguous(), g))
        return K.lk_level_plain(a, b, p.contiguous(), g, radius, iters)

    K.pyramid_track(pyr0, pyr1, pts, valid, level, fb_levels=fb_levels)
    part = {"bytes": 0.0, "operations": 0.0}
    for a, b, p, g in calls:
        t_bytes, t_ops = lk_bound_ms(lk_bytes(a, b, p, g, radius, iters),
                                     p.shape[0], radius, iters)
        part["bytes" if t_bytes >= t_ops else "operations"] += max(
            t_bytes, t_ops)
    return sum(part.values()), max(part, key=part.get)


def level_kernel_phase(torch, dev, imgs, rng):
    """lk_level against its plain version at the 4 levels of the
    temporal pair; its timings and bounds over a frame's level mix."""
    import numpy as np

    from dynamic_vins_tpu_torch.frontend import corners, pyramid
    from dynamic_vins_tpu_torch.ops import lk_check as C
    from dynamic_vins_tpu_torch.ops import lk_level as K

    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    img0, img1 = f32(imgs[10][0]), f32(imgs[11][0])
    cpts, _, found = corners.detect(img0, max_corners=N_FEAT, min_dist=16)
    H, W = img0.shape
    pts = C.with_border_tail(cpts.cpu().numpy(), int(found.sum()), H, W, rng)
    pyr0 = pyramid.build_pyramid(img0, 4)
    pyr1 = pyramid.build_pyramid(img1, 4)
    per_level = []
    max_err = 0.0
    for lvl in range(4):
        s = 2.0 ** lvl
        p = f32(pts / s)
        g = rng.normal(scale=2.0, size=(N_FEAT, 2))
        g[::7] = [40.0, -30.0]      # hits the img1 window clamp
        g = f32(g)
        a, b = pyr0[lvl].contiguous(), pyr1[lvl].contiguous()
        fk, okk = K.lk_level(a, b, p, g)
        torch.cuda.synchronize()
        fp, okp = K.lk_level_plain(a, b, p, g)
        okk_n, okp_n = okk.cpu().numpy(), okp.cpu().numpy()
        if not np.array_equal(okk_n, okp_n):
            fail(f"lk_level ok mask differs from plain at level {lvl}: "
                 f"{int((okk_n != okp_n).sum())} features")
        err = float(np.abs(fk.cpu().numpy()[okp_n]
                           - fp.cpu().numpy()[okp_n]).max())
        if not err <= FLOW_ATOL_PX:
            fail(f"lk_level flow differs from plain at level {lvl}: "
                 f"{err} px > {FLOW_ATOL_PX} px")
        max_err = max(max_err, err)
        flow, ok = torch.empty_like(g), torch.empty_like(okk)
        ms = _timed(torch, lambda: K.launch_level(a, b, p, g, 10, 10, flow,
                                                  ok), 200)
        wrap_ms = _timed(torch, lambda: K.lk_level(a, b, p, g), 200)
        plain_ms = _timed(torch, lambda: K.lk_level_plain(a, b, p, g), 100)
        nbytes = lk_bytes(a, b, p, g, 10, 10)
        t_bytes, t_ops = lk_bound_ms(nbytes, N_FEAT, 10, 10)
        by = "bytes" if t_bytes >= t_ops else "operations"
        per_level.append((ms, plain_ms, max(t_bytes, t_ops), by))
        print(f"lk_level level {lvl} {a.shape[1]}x{a.shape[0]} N={N_FEAT}:"
              f" kernel {ms} ms, wrapper {wrap_ms} ms, plain {plain_ms} ms, "
              f"bound {max(t_bytes, t_ops)} ms ({by}; {nbytes} B -> "
              f"{t_bytes} ms, operations -> {t_ops} ms), max |flow err| "
              f"{err:.2e} px, ok {int(okp_n.sum())}/{N_FEAT}", flush=True)
    # the mix of a track's levels: 3, 2, 1, 0 forward + 0 backward; the
    # mix's bound is the mean of each launch's bound, and bound_by the
    # limit that sets the larger part of it
    mix = [3, 2, 1, 0, 0]
    mean = lambda i: sum(per_level[l][i] for l in mix) / len(mix)
    by_part = {k: sum(per_level[l][2] for l in mix if per_level[l][3] == k)
               for k in ("bytes", "operations")}
    return dict(ms=mean(0), plain_ms=mean(1), bound_ms=mean(2),
                bound_by=max(by_part, key=by_part.get), max_abs_err=max_err)


def track_kernel_phase(torch, dev, imgs, rng):
    """lk_track against its plain version on the slice's temporal and
    stereo pairs; timings and bounds averaged over the two (a frame)."""
    from dynamic_vins_tpu_torch.frontend import corners, pyramid
    from dynamic_vins_tpu_torch.frontend.tracker import TrackerConfig
    from dynamic_vins_tpu_torch.ops import lk_check as C
    from dynamic_vins_tpu_torch.ops import lk_level as K

    tc = TrackerConfig()        # the main path's LK settings
    thr, border = tc.fb_thresh, tc.border
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    rows, max_err = [], 0.0
    for name, (src, dst) in (("temporal 10->11", (imgs[10][0], imgs[11][0])),
                             ("stereo 11 L->R", (imgs[11][0], imgs[11][1]))):
        img0, img1 = f32(src), f32(dst)
        H, W = img0.shape
        cpts, _, found = corners.detect(img0, max_corners=N_FEAT,
                                        min_dist=16)
        pts = f32(C.with_border_tail(cpts.cpu().numpy(), int(found.sum()),
                                     H, W, rng))
        valid = torch.ones(N_FEAT, dtype=torch.bool, device=dev)
        pyr0 = pyramid.build_pyramid(img0, 4)
        pyr1 = pyramid.build_pyramid(img1, 4)
        args = (pyr0, pyr1, pts, valid)
        kw = dict(fb_thresh=thr, border=border, fb_levels=1)
        before = (K.track_launches, K.launches)
        kern = K.lk_track(*args, **kw)
        torch.cuda.synchronize()
        if (K.track_launches, K.launches) != (before[0] + 1, before[1]):
            fail("lk_track did not count exactly one track launch")
        plain = K.lk_track_plain(*args, **kw)
        near = C.near_threshold(*args, plain[0], thr, border, 1)
        err, bad, exempt = C.compare_track(kern, plain, near)
        print(f"lk_track {name}: max |pts1 err| {err:.2e} px, ok differs "
              f"on {bad} features, and on {exempt} within {C.NEAR_PX} px "
              f"of a threshold (expected 0)", flush=True)
        if bad or not err <= FLOW_ATOL_PX:
            fail(f"lk_track differs from plain on {name}: pts1 {err} px, "
                 f"ok on {bad} features")
        max_err = max(max_err, err)
        pts1, ok = torch.empty_like(kern[0]), torch.empty_like(kern[1])
        ms = _timed(torch, lambda: K.launch_track(
            *args, tc.radius, tc.iters, thr, border, 1, pts1, ok), 200)
        wrap_ms = _timed(torch, lambda: K.lk_track(*args, **kw), 200)
        plain_ms = _timed(torch, lambda: K.lk_track_plain(*args, **kw), 20)
        bound, by = track_bound(*args, 1)
        rows.append((ms, plain_ms, bound, by))
        print(f"lk_track {name} {W}x{H} N={N_FEAT}: kernel {ms} ms, wrapper "
              f"{wrap_ms} ms, plain {plain_ms} ms, bound {bound} ms ({by}; "
              f"sum of its 5 levels), ok {int(plain[1].sum())}/{N_FEAT}",
              flush=True)
    mean = lambda i: sum(r[i] for r in rows) / len(rows)
    by = [r[3] for r in rows]
    return dict(ms=mean(0), plain_ms=mean(1), bound_ms=mean(2),
                bound_by=max(set(by), key=by.count), max_abs_err=max_err)


def instance_kernel_phase(torch, dev, dframes, rng):
    """lk_track at radius 8 against its plain version on the instance
    tracker's track: the dynamic scene's frames 10 -> 11, K*N rows of
    which a third are valid (corners inside the merged eroded object
    masks, as the instance tracker tops up), the rest stale positions
    with a border tail; timings and the bound."""
    import numpy as np

    from dynamic_vins_tpu_torch.frontend import corners, pyramid
    from dynamic_vins_tpu_torch.frontend.instance_tracker import (
        InstanceTrackerConfig, _erode3_np)
    from dynamic_vins_tpu_torch.ops import lk_check as C
    from dynamic_vins_tpu_torch.ops import lk_level as K
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    ic = InstanceTrackerConfig()     # the main path's LK settings
    n = ic.max_instances * ic.max_dynamic_cnt
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    df0, df1 = dframes[10], dframes[11]
    img0, img1 = f32(df0.img_left), f32(df1.img_left)
    H, W = img0.shape
    allow = np.zeros((H, W), bool)
    for m in df0.seg.masks:
        allow |= _erode3_np(m, ic.erode_iters)
    cpts, _, found = corners.detect(
        img0, max_corners=n // 3, min_dist=VioConfig().min_dynamic_dist,
        border=2, allow_mask=torch.tensor(allow, device=dev))
    nf = int(found.sum())
    pts = rng.uniform([20, 20], [W - 20, H - 20], size=(n, 2))
    pts[:nf] = cpts[:nf].cpu().numpy()
    pts = C.with_border_tail(pts, n - 20, H, W, rng)
    valid = np.zeros(n, bool)
    valid[:nf] = True
    valid[n - 20:] = True
    perm = rng.permutation(n)        # valid rows spread over the rows
    pts, valid = f32(pts[perm]), torch.tensor(valid[perm], device=dev)
    pyr0 = pyramid.build_pyramid(img0, ic.levels)
    pyr1 = pyramid.build_pyramid(img1, ic.levels)
    args = (pyr0, pyr1, pts, valid)
    kw = dict(radius=ic.radius, iters=ic.iters, fb_thresh=ic.fb_thresh,
              border=3, fb_levels=1)
    before = K.track_launches_by_radius[ic.radius]
    kern = K.lk_track(*args, **kw)
    torch.cuda.synchronize()
    if K.track_launches_by_radius[ic.radius] != before + 1:
        fail("lk_track at radius 8 did not count exactly one launch")
    plain = K.lk_track_plain(*args, **kw)
    near = C.near_threshold(*args, plain[0], ic.fb_thresh, 3, 1,
                            radius=ic.radius)
    err, bad, exempt = C.compare_track(kern, plain, near)
    print(f"lk_track radius 8, instance rows {W}x{H} N={n} ({nf + 20} "
          f"valid), {ic.levels} levels: max |pts1 err| {err:.2e} px, ok "
          f"differs on {bad} features, and on {exempt} within {C.NEAR_PX} "
          f"px of a threshold (expected 0)", flush=True)
    if bad or not err <= FLOW_ATOL_PX:
        fail(f"lk_track at radius 8 differs from plain: pts1 {err} px, ok "
             f"on {bad} features")
    pts1, ok = torch.empty_like(kern[0]), torch.empty_like(kern[1])
    ms = _timed(torch, lambda: K.launch_track(
        *args, ic.radius, ic.iters, ic.fb_thresh, 3, 1, pts1, ok), 200)
    wrap_ms = _timed(torch, lambda: K.lk_track(*args, **kw), 200)
    plain_ms = _timed(torch, lambda: K.lk_track_plain(*args, **kw), 20)
    bound, by = track_bound(*args, 1, radius=ic.radius, iters=ic.iters)
    print(f"lk_track radius 8 N={n}: kernel {ms} ms, wrapper {wrap_ms} ms, "
          f"plain {plain_ms} ms, bound {bound} ms ({by}; sum of its "
          f"{ic.levels + 1} levels), ok {int(plain[1].sum())}/{nf + 20}",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err)


def kernel_phase(torch, dev, imgs, dframes):
    import numpy as np

    rng = np.random.default_rng(SEED)
    return (level_kernel_phase(torch, dev, imgs, rng),
            track_kernel_phase(torch, dev, imgs, rng),
            instance_kernel_phase(torch, dev, dframes, rng))


def slice_config(rig, cfg):
    """Fill a VioConfig (EuRoC-shaped defaults: RAW stereo+IMU) with the
    rig's image size, intrinsics and extrinsics."""
    import numpy as np

    from dynamic_vins_tpu_torch.geometry import lie

    cfg.image_width, cfg.image_height = rig.width, rig.height
    cfg.intrinsics_left = [float(v) for v in rig.intr[:4]]
    T0, T1 = np.eye(4), np.eye(4)
    T0[:3, :3] = lie.quat_to_matrix(rig.q_bc).numpy()
    T0[:3, 3] = rig.p_bc.numpy()
    pr, qr = rig.right_extrinsics()
    T1[:3, :3] = lie.quat_to_matrix(qr).numpy()
    T1[:3, 3] = pr.numpy()
    cfg.body_T_cam0 = T0.reshape(-1).tolist()
    cfg.body_T_cam1 = T1.reshape(-1).tolist()
    return cfg


def reset_counts(K, graphs):
    """Every kernel and replay count to 0 (just before a path runs)."""
    K.launches = K.track_launches = K.plain_levels = 0
    for r in K.track_launches_by_radius:
        K.track_launches_by_radius[r] = 0
    for g in graphs:
        g.replays.clear()


def run_slice(torch, dev, seq, imgs, imus, name, frames=None,
              use_megastep=True, pipelined=False, dynamic_mask=None,
              use_line=False, record=None):
    """Drive the System over the slice's first `frames` (all) frames on one
    path (NAIVE with `dynamic_mask`; LinePoint with `use_line`). Counts
    (kernel launches, step replays) are set to 0 just before the frames
    and read just after. Fails on a count, a feature drought, a
    non-finite output, the ATE gate or (NAIVE) a tracked point inside
    the mask; returns the launch counts, the positions, the step graph
    and, LinePoint, each frame's segments and the System. With `record`
    (a path), every frame the estimator receives is written there by
    `io.feature_serialization.FeatureRecorder`, and the result also
    holds the estimator's own outputs and what a fresh estimator needs
    (its config, extrinsics, noise)."""
    import numpy as np

    from dynamic_vins_tpu_torch.ops import lk_level as K
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import FrameInput, System
    from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig

    frames = frames or FRAMES
    rig = seq.rig
    cfg = slice_config(rig, VioConfig())
    cfg.pipelined = pipelined
    cfg.use_line = use_line
    if dynamic_mask is not None:
        cfg.slam = SlamMode.NAIVE
    system = System(cfg, output_prefix=str(REPO / "output" /
                                           f"chip_smoke_{name}"),
                    device=dev, dtype=torch.float32)
    est = system.estimator
    est.cfg.use_megastep = use_megastep
    print(f"{name}: {rig.width}x{rig.height} stereo+IMU "
          f"{cfg.slam.value.upper()}, blob sigma "
          f"{BLOB_SIGMA_PX} px, window {cfg.window_size}, max_cnt "
          f"{cfg.max_cnt}, estimator dtype {est.dtype}, lm_capacity "
          f"{est.cfg.lm_capacity}, obs_capacity {est.cfg.obs_capacity}, "
          f"megastep {use_megastep}, pipelined {pipelined}, LK backend "
          f"{system.tracker._tracker.backend}, lines {use_line}, {frames} "
          f"frames", flush=True)
    est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                         sim.state_at(seq.frame_times[0])[2].numpy())
    graph = est._pipe if pipelined else est._mega
    # the estimator's steady frames (window full and initialized), which
    # a pipelined System reaches two calls late
    steady_calls = []
    process_frame = est.process_frame
    rec, est_outs = None, []
    if record is not None:
        import dataclasses

        from dynamic_vins_tpu_torch.io.feature_serialization import \
            FeatureRecorder

        rec = FeatureRecorder(record)
        made_with = dict(cfg=dataclasses.replace(est.cfg),
                         p_bc=est.state.p_bc.copy(),
                         q_bc=est.state.q_bc.copy(), noise=est.noise)

    def counted(frame, imu=None, instances=None):
        steady_calls.append(est.initialized
                            and est.frame_count == est.cfg.num_frames - 1)
        if rec is not None:
            rec.record(frame, imu)
        o = process_frame(frame, imu, instances=instances)
        est_outs.append(o)
        return o

    est.process_frame = counted
    steady_from = min(STEADY_FROM, frames - 4)

    gc.collect()                   # the peak is this phase's alone
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, [graph])
    outs, frame_ms, line_segs = [], [], []
    for k in range(frames):
        if k == steady_from:
            torch.cuda.synchronize()
            system.reset_timers()
            t_steady = time.perf_counter()
        t0 = time.perf_counter()
        out = system.process(FrameInput(float(seq.frame_times[k]),
                                        imgs[k][0], imgs[k][1],
                                        imu=imus[k],
                                        dynamic_mask=dynamic_mask))
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        if use_line:
            line_segs.append(list(system.line_tracker.prev_segs))
        nfeat = int(system.tracker.valid.sum())
        if dynamic_mask is not None:
            xy = system.tracker.pts[system.tracker.valid].astype(int)
            inside = int(dynamic_mask[xy[:, 1], xy[:, 0]].sum())
            if inside:
                fail(f"{name}, frame {k}: {inside} tracked points inside "
                     f"the dynamic mask")
        if out is not None:
            outs.append(out)
        if k > 2 and nfeat < 30:
            fail(f"{name}, frame {k}: only {nfeat} features")
    outs += system.drain()
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t_steady) / (frames
                                                         - steady_from)
    if rec is not None:
        rec.close()
    launches = dict(lk_level=K.launches, lk_track=K.track_launches,
                    plain_levels=K.plain_levels)
    replays = sum(graph.replays.values())
    steady = sum(steady_calls)
    stages = system.close()
    peak = torch.cuda.max_memory_allocated() / 2**20
    if launches != dict(lk_level=0, lk_track=2 * frames, plain_levels=0):
        fail(f"{name}: LK kernel launches {launches}, expected lk_track "
             f"{2 * frames} (one a track, two a frame), no per-level "
             f"lk_level launch and no plain level")
    want = steady if use_megastep else 0
    if replays != want:
        fail(f"{name}: {replays} step replays for {steady} steady frames "
             f"(expected {want})")
    if len(outs) != frames or [o.timestamp for o in outs] != \
            [float(t) for t in seq.frame_times[:frames]]:
        fail(f"{name}: {len(outs)} outputs, not one per frame in order")
    if not all(np.isfinite(np.concatenate([o.p, o.q, o.v])).all()
               for o in outs):
        fail(f"{name}: non-finite estimator output")
    if est.failed:
        fail(f"{name}: estimator reported failure")
    p = np.stack([o.p for o in outs])
    ate = frontend_sim.ate_rmse(p, seq.gt_p.numpy()[:frames])
    segs = {str(k): [graph.segments(k), graph.host_syncs(k)]
            for k in graph.chains}
    print(f"{name}: kernel launches {json.dumps(launches)}, step replays "
          f"{replays} for {steady} steady frames, graph segments and host "
          f"syncs per replay (keyframe True/False) {json.dumps(segs)}",
          flush=True)
    print(f"{name}: ATE {ate:.4f} m (unaligned, gate {ATE_GATE_M} m), "
          f"steady ms/frame (frames {steady_from}-{frames - 1}, one "
          f"synchronize at the end) {steady_ms:.2f}, peak device memory "
          f"{peak:.1f} MiB", flush=True)
    print(f"{name}: stage means (ms, steady frames):", json.dumps(stages),
          flush=True)
    print(f"{name}: host ms per call (no synchronize; the first steady "
          f"frame captures the step graphs):",
          json.dumps([round(t, 2) for t in frame_ms]), flush=True)
    if not ate < ATE_GATE_M:
        fail(f"{name}: ATE {ate} m >= {ATE_GATE_M} m")
    out = dict(launches=launches, p=p, graph=graph)
    if use_line:
        out.update(segs=line_segs, system=system)
    if rec is not None:
        out.update(est_outs=est_outs, **made_with)
    return out


def make_dynamic(torch, dev, seq, sigma=BLOB_SIGMA_PX):
    """The slice's scene with N_OBJECTS moving textured boxes and their
    perception artifacts (the port's sim/dynamic_scene)."""
    from dynamic_vins_tpu_torch.sim import dynamic_scene

    return dynamic_scene.make_dynamic_scene(
        seq, num_objects=N_OBJECTS, seed=SEED, sigma=sigma, device=dev)


def run_dynamic(torch, dev, seq, dframes, objs, imus, pipelined=False):
    """The DYNAMIC System over the dynamic scene's frames on its default
    path (or pipelined); counts set to 0 just before the frames and read
    just after. Fails on a count or a gate (module docstring, phases 9
    and 11); returns the kernel launches, the object solve's step graph
    and the steady ms/frame."""
    import numpy as np

    from dynamic_vins_tpu_torch.io.writers import read_mot
    from dynamic_vins_tpu_torch.ops import lk_level as K
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import FrameInput, System
    from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig

    name = "dynamic-pipelined" if pipelined else "dynamic"
    cfg = slice_config(seq.rig, VioConfig())
    cfg.slam = SlamMode.DYNAMIC
    cfg.pipelined = pipelined
    prefix = REPO / "output" / f"chip_smoke_{name}"
    system = System(cfg, output_prefix=str(prefix), device=dev,
                    dtype=torch.float32)
    est, it = system.estimator, system.inst_tracker
    solve = est.im.solve_graph
    step = est._pipe if pipelined else est._mega
    print(f"{name}: {seq.rig.width}x{seq.rig.height} stereo+IMU DYNAMIC"
          f"{' pipelined' if pipelined else ''}, "
          f"{N_OBJECTS} objects, window {cfg.window_size}, max_cnt "
          f"{cfg.max_cnt}, instance rows {it.cfg.max_instances} x "
          f"{it.cfg.max_dynamic_cnt} (LK radius {it.cfg.radius}, "
          f"{it.cfg.levels} levels, backend {it._tracker.backend}), object "
          f"slots {est.im.cfg.max_objects} x {est.im.cfg.lm_per_object} "
          f"landmarks x {est.im.cfg.obs_per_object} obs, estimator dtype "
          f"{est.dtype}, {FRAMES} frames", flush=True)
    est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                         sim.state_at(seq.frame_times[0])[2].numpy())
    steady_calls = []
    process_frame = est.process_frame

    def counted(frame, imu=None, instances=None):
        steady_calls.append(est.initialized
                            and est.frame_count == est.cfg.num_frames - 1)
        return process_frame(frame, imu, instances=instances)

    est.process_frame = counted
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, [step, solve])
    outs, solves_a_frame, frame_ms = [], [], []
    inst_frames = 0
    for k, df in enumerate(dframes):
        if k == STEADY_FROM:
            torch.cuda.synchronize()
            system.reset_timers()
            t_steady = time.perf_counter()
        before = sum(solve.replays.values())
        t0 = time.perf_counter()
        out = system.process(FrameInput(
            float(seq.frame_times[k]), df.img_left, df.img_right,
            imu=imus[k], seg=df.seg, boxes3d=df.boxes3d,
            disparity=df.disparity))
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        solves_a_frame.append(sum(solve.replays.values()) - before)
        inst_frames += bool(len(df.seg.masks))
        if out is not None or not pipelined:
            outs.append(out)
        if k > 2 and int(system.tracker.valid.sum()) < 30:
            fail(f"{name}, frame {k}: only "
                 f"{int(system.tracker.valid.sum())} features")
    outs += system.drain()
    inst = est.get_instance_states()
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t_steady) / (FRAMES
                                                         - STEADY_FROM)
    launches = dict(lk_level=K.launches, plain_levels=K.plain_levels,
                    **{f"lk_track_r{r}": n for r, n
                       in K.track_launches_by_radius.items()})
    replays = sum(step.replays.values())
    steady = sum(steady_calls)
    stages = system.close()
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = dict(lk_level=0, plain_levels=0, lk_track_r8=2 * inst_frames,
                lk_track_r10=2 * FRAMES)
    print(f"{name}: kernel launches {json.dumps(launches)} ({inst_frames} "
          f"frames with instances), {'pipelined-step' if pipelined else 'megastep'}"
          f" replays {replays} for {steady} "
          f"steady frames, object-solve replays a frame "
          f"{json.dumps(solves_a_frame)} (segments "
          f"{solve.segments(0) if solve.chains else 0}, host syncs "
          f"{solve.host_syncs(0) if solve.chains else 0})", flush=True)
    if launches != want:
        fail(f"{name}: LK launches {launches}, expected {want}")
    if replays != steady or max(solves_a_frame) > 1 \
            or sum(solves_a_frame) == 0:
        fail(f"{name}: {replays} step replays for {steady} steady "
             f"frames, object-solve replays a frame {solves_a_frame}")
    if any(o is None for o in outs) or [o.timestamp for o in outs] != \
            [float(t) for t in seq.frame_times] or est.failed or not all(
            np.isfinite(np.concatenate([o.p, o.q, o.v])).all()
            for o in outs):
        fail(f"{name}: not one output a frame in order, a non-finite "
             f"output, or estimator failure")
    p = np.stack([o.p for o in outs])
    ate = frontend_sim.ate_rmse(p, seq.gt_p.numpy())
    errs = {tid: min(float(np.linalg.norm(o.gt_p[-1] - s["p"]))
                     for o in objs) for tid, s in inst.items()}
    rows = read_mot(str(prefix) + "_mot.txt")
    print(f"{name}: ego ATE {ate:.4f} m (gate {DYN_ATE_GATE_M} m), instance"
          f" errors to the nearest object's truth (m) {json.dumps(errs)} "
          f"(gate: one below {DYN_OBJ_GATE_M} m), {len(rows)} MOT rows, "
          f"track ids {sorted({r['tid'] for r in rows})}", flush=True)
    print(f"{name}: steady ms/frame (frames {STEADY_FROM}-{FRAMES - 1}, one "
          f"synchronize at the end) {steady_ms:.2f}, peak device memory "
          f"{peak:.1f} MiB", flush=True)
    print(f"{name}: stage means (ms, steady frames):", json.dumps(stages),
          flush=True)
    print(f"{name}: host ms per call:",
          json.dumps([round(t, 2) for t in frame_ms]), flush=True)
    if not ate < DYN_ATE_GATE_M:
        fail(f"{name}: ego ATE {ate} m >= {DYN_ATE_GATE_M} m")
    if not errs or not min(errs.values()) < DYN_OBJ_GATE_M:
        fail(f"{name}: no instance within {DYN_OBJ_GATE_M} m of an "
             f"object's truth: {errs}")
    if not rows:
        fail(f"{name}: the KITTI-MOT file is empty")
    return dict(launches=launches, solve=solve, steady_ms=steady_ms)


def write_config(path, cfg: dict):
    """A flat YAML config as a user writes one: `key: value` lines, lists
    in flow style, floats with a point and a signed exponent (so a YAML
    1.1 reader types them as floats)."""
    def scalar(v):
        return f"{v:.12e}" if isinstance(v, float) else str(v)

    Path(path).write_text("".join(
        f"{k}: " + ("[" + ", ".join(scalar(float(x)) for x in v) + "]"
                    if isinstance(v, (list, tuple)) else scalar(v)) + "\n"
        for k, v in cfg.items()))


def run_cli(torch, name, argv, frames):
    """`run.main(argv)` in this process, with the System it builds
    recorded (the estimator's steady calls, object-solve replays a
    call); every count set to 0 just before and read just after. Fails
    unless the run returns 0; returns (System, launches, ms/frame)."""
    from dynamic_vins_tpu_torch import run
    from dynamic_vins_tpu_torch.ops import lk_level as K

    made = []

    class Recorded(run.System):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            self.steady_calls, self.solves = [], []
            est = self.estimator
            process_frame = est.process_frame

            def counted(frame, imu=None, instances=None):
                self.steady_calls.append(
                    est.initialized
                    and est.frame_count == est.cfg.num_frames - 1)
                return process_frame(frame, imu, instances=instances)

            est.process_frame = counted

        def process(self, fi):
            im = self.estimator.im
            before = sum(im.solve_graph.replays.values()) if im else 0
            out = super().process(fi)
            if im is not None:
                self.solves.append(sum(im.solve_graph.replays.values())
                                   - before)
            return out

    print(f"{name}: python -m dynamic_vins_tpu_torch.run "
          f"{' '.join(argv)}", flush=True)
    orig, run.System = run.System, Recorded
    try:
        gc.collect()
        torch.cuda.synchronize()
        reset_counts(K, [])
        t0 = time.perf_counter()
        rc = run.main(argv)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / frames
    finally:
        run.System = orig
    if rc != 0 or len(made) != 1:
        fail(f"{name}: run.main returned {rc} ({len(made)} Systems)")
    launches = dict(lk_level=K.launches, plain_levels=K.plain_levels,
                    **{f"lk_track_r{r}": n for r, n
                       in K.track_launches_by_radius.items()})
    return made[0], launches, ms


def cli_phase(torch, seq, imgs, dframes, objs):
    """Phase 12: the slice's scene as an EuRoC tree and the dynamic scene
    as a KITTI tracking tree, written through the port's encoder, run
    through the CLI (module docstring)."""
    import shutil

    import numpy as np

    from dynamic_vins_tpu_torch.geometry import lie_np
    from dynamic_vins_tpu_torch.io import eval_tools, image_io, perception
    from dynamic_vins_tpu_torch.io.evaluation import ate_rmse
    from dynamic_vins_tpu_torch.io.writers import read_mot, read_tum
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    root = REPO / "output" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    rig = seq.rig
    base = slice_config(rig, VioConfig())
    rig_cfg = dict(image_width=rig.width, image_height=rig.height,
                   intrinsics_left=base.intrinsics_left,
                   intrinsics_right=base.intrinsics_left,
                   body_T_cam0=base.body_T_cam0,
                   body_T_cam1=base.body_T_cam1)
    ft = seq.frame_times.numpy()
    u8 = lambda a: np.clip(np.asarray(a), 0, 255).astype(np.uint8)

    def decoded_equal(name, pairs):
        """Decode every (path, bytes) pair; fail unless equal; ms a
        frame (both cameras), after one decode that builds the C
        unfilter at first use (its ms printed apart)."""
        t0 = time.perf_counter()
        image_io.imread(pairs[0][0], "grey")
        first_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = [image_io.imread(path, "grey") for path, _ in pairs]
        ms = 1e3 * (time.perf_counter() - t0) / (len(pairs) / 2)
        bad = sum(not np.array_equal(g, want)
                  for g, (_, want) in zip(got, pairs))
        if bad:
            fail(f"{name}: {bad} decoded images differ from the written "
                 f"bytes")
        print(f"{name}: the first decode took {first_ms:.2f} ms (the C "
              f"unfilter builds at first use)", flush=True)
        return ms

    # ---- EuRoC: RAW stereo+IMU ----------------------------------------
    t0 = time.perf_counter()
    eu = root / "euroc" / "mav0"
    pairs = []
    for c, cam in enumerate(("cam0", "cam1")):
        (eu / cam / "data").mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for k in range(FRAMES):
            ns = int(round(ft[k] * 1e9))
            path = eu / cam / "data" / f"{ns}.png"
            image_io.imwrite(path, u8(imgs[k][c]))
            pairs.append((path, u8(imgs[k][c])))
            rows.append(f"{ns},{ns}.png")
        (eu / cam / "data.csv").write_text("\n".join(rows) + "\n")
    it, acc, gyr = (seq.imu_times.numpy(), seq.acc.numpy(),
                    seq.gyr.numpy())
    (eu / "imu0").mkdir()
    (eu / "imu0" / "data.csv").write_text(
        "#timestamp,w_x,w_y,w_z,a_x,a_y,a_z\n" + "".join(
            f"{int(round(it[i] * 1e9))},{gyr[i, 0]},{gyr[i, 1]},"
            f"{gyr[i, 2]},{acc[i, 0]},{acc[i, 1]},{acc[i, 2]}\n"
            for i in range(len(it))))
    gp, gq = seq.gt_p.numpy(), seq.gt_q.numpy()
    (eu / "state_groundtruth_estimate0").mkdir()
    (eu / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp,p,q\n" + "".join(
            f"{int(round(ft[k] * 1e9))},{gp[k, 0]},{gp[k, 1]},"
            f"{gp[k, 2]},{gq[k, 0]},{gq[k, 1]},{gq[k, 2]},"
            f"{gq[k, 3]}\n" for k in range(FRAMES)))
    write_config(root / "euroc.yaml", dict(rig_cfg, dataset="euroc",
                                           slam="raw", imu=1))
    write_s = time.perf_counter() - t0
    dec_ms = decoded_equal("cli-euroc", pairs)
    out = str(root / "euroc_run")
    system, launches, ms = run_cli(
        torch, "cli-euroc", ["--dataset", "euroc", "--root",
                             str(root / "euroc"), "--config",
                             str(root / "euroc.yaml"), "--output", out],
        FRAMES)
    est = system.estimator
    replays = sum(est._mega.replays.values())
    steady = sum(system.steady_calls)
    t_est, p_est, _ = read_tum(out + "_ego_tum.txt")
    ate = ate_rmse(t_est, p_est, ft, gp, align=True)
    print(f"cli-euroc: wrote the tree in {write_s:.2f} s; decode "
          f"{dec_ms:.3f} ms a frame (2 PNGs {rig.width}x{rig.height}, "
          f"equal to the written bytes); kernel launches "
          f"{json.dumps(launches)}, megastep replays {replays} for "
          f"{steady} steady frames, estimator dtype {est.dtype}; "
          f"{len(t_est)} poses, aligned ATE {ate:.4f} m (gate "
          f"{ATE_GATE_M} m); {ms:.2f} ms/frame over the whole run "
          f"(graph captures included)", flush=True)
    want = dict(lk_level=0, plain_levels=0, lk_track_r8=0,
                lk_track_r10=2 * FRAMES)
    if launches != want or replays != steady or not steady:
        fail(f"cli-euroc: launches {launches} (expected {want}), "
             f"{replays} replays for {steady} steady frames")
    if len(t_est) != FRAMES or not np.isfinite(p_est).all() \
            or not ate < ATE_GATE_M:
        fail(f"cli-euroc: {len(t_est)} poses, aligned ATE {ate} m")
    total = dict(launches)

    # ---- the same tree, mono+IMU (is_stereo: 0) ------------------------
    write_config(root / "euroc_mono.yaml", dict(
        rig_cfg, dataset="euroc", slam="raw", imu=1, is_stereo=0))
    out = str(root / "euroc_mono_run")
    system, launches, ms = run_cli(
        torch, "cli-euroc-mono", ["--dataset", "euroc", "--root",
                                  str(root / "euroc"), "--config",
                                  str(root / "euroc_mono.yaml"),
                                  "--output", out], FRAMES)
    est = system.estimator
    replays = sum(est._mega.replays.values())
    steady = sum(system.steady_calls)
    t_est, p_est, _ = read_tum(out + "_ego_tum.txt")
    print(f"cli-euroc-mono: kernel launches {json.dumps(launches)}, "
          f"megastep replays {replays} for {steady} steady frames, "
          f"estimator dtype {est.dtype}, stereo {est.cfg.stereo}, "
          f"initialized {est.initialized}; {len(t_est)} poses; "
          f"{ms:.2f} ms/frame over the whole run", flush=True)
    want = dict(lk_level=0, plain_levels=0, lk_track_r8=0,
                lk_track_r10=FRAMES)
    if launches != want or replays != steady or not steady \
            or est.cfg.stereo or not est.initialized or est.failed:
        fail(f"cli-euroc-mono: launches {launches} (expected {want}), "
             f"{replays} replays for {steady} steady frames, "
             f"initialized {est.initialized}, failed {est.failed}")
    if len(t_est) != FRAMES or not np.isfinite(p_est).all():
        fail(f"cli-euroc-mono: {len(t_est)} poses, finite "
             f"{np.isfinite(p_est).all()}")
    for key, n in launches.items():
        total[key] += n

    # ---- KITTI tracking: DYNAMIC, no IMU, offline artifacts ----------
    t0 = time.perf_counter()
    ki = root / "kitti"
    left, right = ki / "image_02" / "0000", ki / "image_03" / "0000"
    arts = {d: ki / d / "0000" for d in ("seg", "det3d", "disp")}
    for d in (left, right, *arts.values(), ki / "label_02"):
        d.mkdir(parents=True)
    pairs, gt_lines, inst_frames = [], [], 0
    p_bc, q_bc = rig.p_bc.numpy(), rig.q_bc.numpy()
    for k, df in enumerate(dframes):
        name = f"{k:06d}"
        for d, img in ((left, df.img_left), (right, df.img_right)):
            image_io.imwrite(d / f"{name}.png", u8(img))
            pairs.append((d / f"{name}.png", u8(img)))
        perception.write_solo_seg_pt(str(arts["seg"]), name, df.seg)
        perception.write_fcos3d_txt(str(arts["det3d"] / f"{name}.txt"),
                                    df.boxes3d)
        perception.write_disparity_png(str(arts["disp"] / f"{name}.png"),
                                       df.disparity)
        inst_frames += bool(len(df.seg.masks))
        # ground-truth labels: each box's object by its camera-frame
        # centre (the scene drops objects out of view)
        p_wc, q_wc = lie_np.pose_compose(gp[k], gq[k], p_bc, q_bc)
        p_cw, q_cw = lie_np.pose_inverse(p_wc, q_wc)
        cams = [lie_np.pose_transform_point(p_cw, q_cw, o.gt_p[k])
                for o in objs]
        for m, b3 in zip(df.seg.masks, df.boxes3d):
            tid = objs[int(np.argmin([np.linalg.norm(c - b3.center)
                                      for c in cams]))].track_id
            ys, xs = np.nonzero(m)
            h, w, l = b3.dims[1], b3.dims[2], b3.dims[0]
            x, y, z = b3.bottom_center
            gt_lines.append(
                f"{k} {tid} Car 0 0 0 {xs.min()} {ys.min()} {xs.max()} "
                f"{ys.max()} {h:.4f} {w:.4f} {l:.4f} {x:.4f} {y:.4f} "
                f"{z:.4f} {b3.yaw:.4f}")
    labels = ki / "label_02" / "0000.txt"
    labels.write_text("\n".join(gt_lines) + "\n")
    write_config(root / "kitti.yaml", dict(rig_cfg, dataset="kitti",
                                           slam="dynamic", imu=0))
    write_s = time.perf_counter() - t0
    dec_ms = decoded_equal("cli-kitti", pairs)
    for k, df in enumerate(dframes):
        name = f"{k:06d}"
        disp = perception.read_disparity_png(str(arts["disp"]
                                                 / f"{name}.png"))
        seg = perception.read_solo_seg_pt(str(arts["seg"]), name)
        q = np.clip(df.disparity * np.float32(256), 0, 65535).astype(
            np.uint16).astype(np.float32) / 256
        if not (np.array_equal(disp, q)
                and np.array_equal(seg.masks, df.seg.masks)):
            fail(f"cli-kitti, frame {k}: the disparity or segmentation "
                 f"read back differs from what was written")
    out = str(root / "kitti_run")
    system, launches, ms = run_cli(
        torch, "cli-kitti", ["--dataset", "kitti", "--left", str(left),
                             "--right", str(right), "--seg-dir",
                             str(arts["seg"]), "--det3d-dir",
                             str(arts["det3d"]), "--disp-dir",
                             str(arts["disp"]), "--config",
                             str(root / "kitti.yaml"), "--slam", "dynamic",
                             "--output", out], FRAMES)
    est = system.estimator
    replays = sum(est._mega.replays.values())
    steady = sum(system.steady_calls)
    t_est, p_est, _ = read_tum(out + "_ego_tum.txt")
    t_gt = np.arange(FRAMES) * 0.1          # the reader's 10 Hz stamps
    ate = ate_rmse(t_est, p_est, t_gt, gp, align=True)
    rows = read_mot(out + "_mot.txt")
    mot = eval_tools.clear_mot(eval_tools.read_mot_file(str(labels)),
                               eval_tools.read_mot_file(out + "_mot.txt"))
    print(f"cli-kitti: wrote the tree in {write_s:.2f} s; decode "
          f"{dec_ms:.3f} ms a frame (2 PNGs, equal to the written bytes; "
          f"disparity and segmentation read back equal); kernel launches "
          f"{json.dumps(launches)} ({inst_frames} frames with instances), "
          f"megastep replays {replays} for {steady} steady frames, "
          f"object-solve replays a call {json.dumps(system.solves)}, "
          f"estimator dtype {est.dtype} without IMU; {len(t_est)} poses, "
          f"aligned ATE {ate:.4f} m (gate {ATE_GATE_M} m); "
          f"{ms:.2f} ms/frame over the whole run", flush=True)
    print(f"cli-kitti: CLEAR-MOT against the ground-truth labels (2D IoU "
          f">= 0.5): MOTA {mot.mota:.4f}, MOTP {mot.motp:.4f}, ID switches "
          f"{mot.id_switches}, FP {mot.fp}, FN {mot.fn}, matches "
          f"{mot.matches} of {mot.gt_total}; {len(rows)} MOT rows, "
          f"{len({r['tid'] for r in rows})} track ids for {len(objs)} "
          f"objects", flush=True)
    want = dict(lk_level=0, plain_levels=0, lk_track_r8=2 * inst_frames,
                lk_track_r10=2 * FRAMES)
    if launches != want or replays != steady or not steady \
            or max(system.solves) > 1 or not sum(system.solves):
        fail(f"cli-kitti: launches {launches} (expected {want}), "
             f"{replays} replays for {steady} steady frames, object-solve "
             f"replays a call {system.solves}")
    if len(t_est) != FRAMES or not np.isfinite(p_est).all() \
            or not ate < ATE_GATE_M:
        fail(f"cli-kitti: {len(t_est)} poses, aligned ATE {ate} m")
    if not rows:
        fail("cli-kitti: the KITTI-MOT file is empty")
    for key, n in launches.items():
        total[key] += n
    return total


def mono_phase(torch, dev, seq, imgs, imus):
    """Phase 13: the mono+IMU System on the slice's scene (module
    docstring). Counts set to 0 just before the frames, read just after;
    returns the launch counts."""
    import numpy as np

    from dynamic_vins_tpu_torch.io.evaluation import (ate_rmse,
                                                      umeyama_alignment)
    from dynamic_vins_tpu_torch.ops import lk_level as K
    from dynamic_vins_tpu_torch.system import FrameInput, System
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    name = "mono"
    cfg = slice_config(seq.rig, VioConfig())
    cfg.is_stereo = False
    system = System(cfg, output_prefix=str(REPO / "output" /
                                           "chip_smoke_mono"), device=dev)
    est = system.estimator
    init_by = FRAMES - MONO_STEADY - 1
    print(f"{name}: {seq.rig.width}x{seq.rig.height} mono+IMU RAW, window "
          f"{cfg.window_size}, max_cnt {cfg.max_cnt}, estimator dtype "
          f"{est.dtype}, megastep {est.cfg.use_megastep}, LK backend "
          f"{system.tracker._tracker.backend}; initialized by frame "
          f"{init_by}, then {MONO_STEADY} steady frames", flush=True)
    init_calls = []
    initialize_mono = est._initialize_mono

    def timed_init():
        t0 = time.perf_counter()
        ok = initialize_mono()
        init_calls.append((round(1e3 * (time.perf_counter() - t0), 2), ok))
        return ok

    est._initialize_mono = timed_init
    graph = est._mega
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, [graph])
    outs, init, steady, frame_ms = [], None, 0, []
    for k in range(FRAMES):
        # the first steady frame captures the graphs: time the rest
        if init is not None and k == init + 2:
            torch.cuda.synchronize()
            system.reset_timers()
            t_steady = time.perf_counter()
        steady += (est.initialized
                   and est.frame_count == est.cfg.num_frames - 1)
        t0 = time.perf_counter()
        out = system.process(FrameInput(float(seq.frame_times[k]),
                                        imgs[k][0], imgs[k][1],
                                        imu=imus[k]))
        frame_ms.append(round(1e3 * (time.perf_counter() - t0), 2))
        outs.append(out)
        if init is None and est.initialized:
            init = k
        if init is None and k >= init_by:
            fail(f"{name}: not initialized by frame {k} (attempts, host ms "
                 f"and result: {init_calls})")
        if init is not None and k == init + MONO_STEADY:
            break
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t_steady) / (MONO_STEADY - 1)
    frames = len(outs)
    launches = dict(lk_level=K.launches, lk_track=K.track_launches,
                    plain_levels=K.plain_levels)
    replays = sum(graph.replays.values())
    stages = system.close()
    peak = torch.cuda.max_memory_allocated() / 2**20
    ft = seq.frame_times.numpy()[:frames]
    gt = seq.gt_p.numpy()[:frames]
    p = np.stack([o.p for o in outs])
    a = init + 10
    ate = ate_rmse(ft[a:], p[a:], ft[a:], gt[a:], align=True,
                   with_scale=False)
    scale, R, t = umeyama_alignment(p[a:], gt[a:], with_scale=True)
    shape = float(np.sqrt(np.mean(np.sum(
        (scale * p[a:] @ R.T + t - gt[a:]) ** 2, axis=-1))))
    print(f"{name}: initialized on frame {init} (host ms and result of "
          f"each attempt: {init_calls}); kernel launches "
          f"{json.dumps(launches)} over {frames} frames, megastep replays "
          f"{replays} for {steady} steady frames", flush=True)
    print(f"{name}: frames {a}-{frames - 1}: ATE after a similarity "
          f"alignment {shape:.4f} m (gate {MONO_ATE_GATE_M} m); Umeyama "
          f"scale {scale:.4f} and ATE aligned without scale {ate:.4f} m "
          f"(not gated; the JAX System on the CPU: 6.31, 0.289 m); steady "
          f"ms/frame (frames {init + 2}-{frames - 1}, after the capture "
          f"frame) {steady_ms:.2f}, peak device memory {peak:.1f} MiB",
          flush=True)
    print(f"{name}: stage means (ms, the same frames):", json.dumps(stages),
          flush=True)
    print(f"{name}: host ms per call (no synchronize):",
          json.dumps(frame_ms), flush=True)
    if launches != dict(lk_level=0, lk_track=frames, plain_levels=0):
        fail(f"{name}: LK kernel launches {launches}, expected lk_track "
             f"{frames} (the temporal track, one a frame) and no level "
             f"launch or plain level")
    if replays != steady or steady != MONO_STEADY:
        fail(f"{name}: {replays} replays for {steady} steady frames "
             f"(expected {MONO_STEADY})")
    if not est.initialized or est.failed \
            or not np.isfinite(p).all():
        fail(f"{name}: initialized {est.initialized}, failed {est.failed},"
             f" finite {np.isfinite(p).all()}")
    if not shape < MONO_ATE_GATE_M:
        fail(f"{name}: ATE after a similarity alignment {shape} m")
    return launches


def mono_reference_phase(torch, dev):
    """Phase 13, second part: tests/test_mono_vio.py's protocol and gates
    on the card, the estimator alone in float64 on the megastep."""
    import numpy as np

    from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                            EstimatorConfig)
    from dynamic_vins_tpu_torch.io.evaluation import (ate_rmse,
                                                      umeyama_alignment)
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim

    seq = sim.generate_sequence(num_frames=MONO_REF_FRAMES, imu_hz=200.0,
                                acc_noise=0.02, gyr_noise=0.002,
                                num_landmarks=250, seed=0)
    frames = frontend_sim.make_frames(seq, pixel_noise=0.5, stereo=False,
                                      seed=0)
    pr, qr = seq.rig.right_extrinsics()
    est = Estimator(EstimatorConfig(num_frames=11, lm_capacity=384,
                                    obs_capacity=6144, stereo=False,
                                    dtype=torch.float64),
                    np.stack([seq.rig.p_bc.numpy(), pr.numpy()]),
                    np.stack([seq.rig.q_bc.numpy(), qr.numpy()]),
                    device=dev)
    t0 = time.perf_counter()
    outs, init = [], None
    for k, (f, imu) in enumerate(frames):
        outs.append(est.process_frame(f, imu))
        if init is None and est.initialized:
            init = k
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(frames)
    a = MONO_REF_FROM
    t = seq.frame_times.numpy()[a:]
    p = np.stack([o.p for o in outs])[a:]
    gt = seq.gt_p.numpy()[a:]
    ate = ate_rmse(t, p, t, gt, align=True, with_scale=False)
    scale = umeyama_alignment(p, gt, with_scale=True)[0]
    replays = sum(est._mega.replays.values())
    print(f"mono-reference: tests/test_mono_vio.py's protocol ("
          f"{MONO_REF_FRAMES} feature-domain mono frames at 10 Hz), "
          f"float64, megastep: initialized on frame {init}, {replays} "
          f"replays; frames {a}-{MONO_REF_FRAMES - 1}: ATE aligned without "
          f"scale {ate:.4f} m (gate {MONO_ATE_GATE_M} m), Umeyama scale "
          f"{scale:.4f} (gate 1 +- {MONO_SCALE_TOL}); {ms:.2f} ms/frame "
          f"over the whole run", flush=True)
    if init is None or est.failed or not replays:
        fail(f"mono-reference: initialized on {init}, failed {est.failed}, "
             f"{replays} replays")
    if not (ate < MONO_ATE_GATE_M and abs(scale - 1.0) < MONO_SCALE_TOL):
        fail(f"mono-reference: ATE {ate} m, scale {scale}")


def resume_phase(torch, dev, seq):
    """Phase 14: a checkpoint after RESUME_AT frames, loaded into a fresh
    estimator on the megastep, against the uninterrupted run (module
    docstring)."""
    import numpy as np

    from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                            EstimatorConfig)
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import obs_capacity
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    cfg = VioConfig()
    F = cfg.num_frames
    frames = frontend_sim.make_frames(seq, max_feats=N_FEAT,
                                      pixel_noise=0.5)
    pr, qr = seq.rig.right_extrinsics()
    p_bc = np.stack([seq.rig.p_bc.numpy(), pr.numpy()])
    q_bc = np.stack([seq.rig.q_bc.numpy(), qr.numpy()])

    def fresh():
        est = Estimator(EstimatorConfig(
            num_frames=F, obs_capacity=obs_capacity(cfg),
            dtype=torch.float64), p_bc, q_bc, device=dev)
        est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                             sim.state_at(seq.frame_times[0])[2].numpy())
        return est

    path = REPO / "output" / "chip_smoke_resume.npz"
    path.parent.mkdir(exist_ok=True)
    whole = fresh()
    p_whole = []
    for k, (f, imu) in enumerate(frames):
        p_whole.append(whole.process_frame(f, imu).p)
        if k == RESUME_AT - 1:
            t0 = time.perf_counter()
            whole.save_checkpoint(str(path))
            save_ms = 1e3 * (time.perf_counter() - t0)
    resumed = fresh()
    t0 = time.perf_counter()
    resumed.load_checkpoint(str(path))
    load_ms = 1e3 * (time.perf_counter() - t0)
    p_res = [resumed.process_frame(f, imu).p for f, imu in
             frames[RESUME_AT:]]
    gap = float(np.abs(np.stack(p_res) - np.stack(p_whole[RESUME_AT:]))
                .max())
    rep_whole = sum(whole._mega.replays.values())
    rep_res = sum(resumed._mega.replays.values())
    # the same checkpoint into the uninterrupted estimator, whose graphs
    # were captured long before: its last frames again
    whole.load_checkpoint(str(path))
    p_again = [whole.process_frame(f, imu).p for f, imu in
               frames[RESUME_AT:]]
    gap2 = float(np.abs(np.stack(p_again)
                        - np.stack(p_whole[RESUME_AT:])).max())
    rep_again = sum(whole._mega.replays.values()) - rep_whole
    print(f"resume: float64, checkpoint after {RESUME_AT} frames "
          f"({path.stat().st_size / 2**20:.2f} MiB, saved in {save_ms:.1f} "
          f"ms, loaded in {load_ms:.1f} ms); the last "
          f"{FRAMES - RESUME_AT} frames resumed in a fresh estimator: max "
          f"|p - p_uninterrupted| {gap:.3e} m (bound {REPLAY_POS_ATOL_M} "
          f"m); megastep replays {rep_whole} uninterrupted, {rep_res} "
          f"resumed; loaded again into the uninterrupted estimator (its "
          f"graphs captured before): max gap {gap2:.3e} m over "
          f"{rep_again} replays", flush=True)
    if whole.failed or resumed.failed or not gap <= REPLAY_POS_ATOL_M \
            or not gap2 <= REPLAY_POS_ATOL_M:
        fail(f"resume: the resumed runs part by {gap} / {gap2} m (failed "
             f"{whole.failed} / {resumed.failed})")
    n = FRAMES - RESUME_AT
    if (rep_whole, rep_res, rep_again) != (FRAMES - F, n, n):
        fail(f"resume: {rep_whole} / {rep_res} / {rep_again} replays, "
             f"expected {FRAMES - F} / {n} / {n}")


def solve_times(torch, graph):
    """CUDA-event ms of the object solve eager and of one replay, on the
    graph's last inputs, and the largest difference between the two."""
    eager = graph.fn(0, graph.inputs)
    replay = graph.replay(0).clone()
    return dict(eager_ms=_timed(torch, lambda: graph.fn(0, graph.inputs), 3),
                replay_ms=_timed(torch, lambda: graph.replay(0), 20),
                max_abs_diff=float((eager - replay).abs().max()))


def device_busy(torch, fn):
    """(ms the card spent in kernels and copies during one call of fn,
    CUDA-event ms of that call), from a torch.profiler trace; None where
    the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return (busy_us / 1e3 if busy_us > 0 else None), a.elapsed_time(b)


def chain_times(torch, chain, reps=20):
    """CUDA-event ms of each graph segment and each host-synced call of a
    graph chain, in the order of a full replay, mean over `reps`
    replays after 3 warm-up ones: (segment ms, [[call, ms], ...])."""
    sums = None
    for rep in range(reps + 3):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark():
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

        chain.replay(mark)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        if rep >= 3:
            sums = ms if sums is None else [x + y for x, y in zip(sums, ms)]
    mean = [x / reps for x in sums]
    return mean[0::2], [[fn.__name__, t]
                        for (fn, _, _), t in zip(chain.calls, mean[1::2])]


def step_times(torch, graph):
    """CUDA-event ms of one eager step and of one replay of its graph
    chain, per branch, on the graph's last inputs; of each graph segment
    and each host-synced call of the chain alone; and the card's busy
    time within one replay (profiler)."""
    res = {}
    for key in (True, False):
        chain = graph.chains[key]
        busy, wall = device_busy(torch, lambda: graph.replay(key))
        segments, calls = chain_times(torch, chain)
        res["keyframe" if key else "non-keyframe"] = dict(
            replay_busy_ms=busy, replay_traced_ms=wall,
            eager_ms=_timed(torch, lambda: graph.fn(key, graph.inputs), 3),
            replay_ms=_timed(torch, lambda: graph.replay(key), 20),
            segments_ms=segments, host_synced_ms=calls)
    return res


def graph_check_phase(torch, dev, seq):
    """In float64 at the slice's widths on the scene's feature-domain
    frames (the estimator alone, as tests/test_pipelined.py runs it):
    the pipelined estimator's outputs against the sequential one's, and
    a replay of each branch against the eager step on the last frame's
    inputs, for both steps."""
    import numpy as np

    from dynamic_vins_tpu_torch.estimator import step_check
    from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                            EstimatorConfig)
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import obs_capacity
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    cfg = VioConfig()
    F = cfg.num_frames
    frames = frontend_sim.make_frames(seq, max_feats=N_FEAT,
                                      pixel_noise=0.5)
    pr, qr = seq.rig.right_extrinsics()
    p_bc = np.stack([seq.rig.p_bc.numpy(), pr.numpy()])
    q_bc = np.stack([seq.rig.q_bc.numpy(), qr.numpy()])
    outs = {}
    for pipelined in (False, True):
        # the slice's widths: System's capacities for VioConfig defaults
        est = Estimator(EstimatorConfig(
            num_frames=F, obs_capacity=obs_capacity(cfg),
            pipelined=pipelined, dtype=torch.float64), p_bc, q_bc,
            device=dev)
        est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                             sim.state_at(seq.frame_times[0])[2].numpy())
        res = [est.process_frame(f, imu) for f, imu in frames]
        res = [o for o in res if o is not None] + est.flush()
        outs[pipelined] = {o.timestamp: o.p for o in res}
        graph = est._pipe if pipelined else est._mega
        if est.failed or len(res) != FRAMES \
                or sum(graph.replays.values()) != FRAMES - F:
            fail(f"graph check (pipelined {pipelined}): estimator failed, "
                 f"{len(res)} outputs or {graph.replays} replays")
        for key in (True, False):
            eager = graph.fn(key, graph.inputs)
            replay = graph.replay(key)
            agree = step_check.agreement(est._consts, eager, replay)
            print(f"graph check: pipelined {pipelined} keyframe {key}: "
                  f"{graph.segments(key)} segments, {graph.host_syncs(key)}"
                  f" host syncs, replay vs eager {json.dumps(agree)}",
                  flush=True)
            if not (agree["masks_equal"]
                    and agree["pos_m"] <= REPLAY_POS_ATOL_M):
                fail(f"graph replay differs from the eager step "
                     f"(pipelined {pipelined}, keyframe {key}): {agree}")
        del est, graph
        torch.cuda.empty_cache()
    gap = max(float(np.abs(p - outs[False][t]).max())
              for t, p in outs[True].items())
    print(f"graph check: pipelined against sequential, float64, {FRAMES} "
          f"frames: max |p - p_sequential| {gap:.3e} m (bound "
          f"{PIPE_POS_ATOL_M} m)", flush=True)
    if not gap <= PIPE_POS_ATOL_M:
        fail(f"pipelined parts from the sequential estimator by {gap} m")


def line_segments_world():
    """The LinePoint scene's world segments (s_w, e_w [N,3]) and the
    feature-domain helper that projects them."""
    from dynamic_vins_tpu_torch.sim import frontend_sim

    return frontend_sim.make_line_segments(N_SEGMENTS, seed=9)


def draw_strokes(img, seq, k, cam, s_w, e_w):
    """`img` [H,W] with the world segments drawn in camera `cam` of frame
    k as bright antialiased strokes 2 px wide at half height (3 px
    edge ramps: a hard-edged stroke makes the profile along a detected
    edge follow the edge's subpixel position instead of the stroke),
    blended over the image. A stroke's brightness (45-255) varies along it with
    the position on the world segment, 1-3 cosine periods with
    amplitudes and phases of its own (seeded): a real edge carries
    texture, and the line tracker's descriptor is the intensity profile
    along the segment, which a uniform stroke leaves flat and a single
    period makes alike from segment to segment. Segments with an end closer than 0.5 m
    are left out."""
    import numpy as np
    import torch

    from dynamic_vins_tpu_torch.geometry import camera, lie_np

    rig = seq.rig
    pr, qr = rig.right_extrinsics()
    p_bc, q_bc = ((rig.p_bc, rig.q_bc), (pr, qr))[cam]
    p_cw, q_cw = lie_np.pose_inverse(*lie_np.pose_compose(
        seq.gt_p[k].numpy(), seq.gt_q[k].numpy(), p_bc.numpy(),
        q_bc.numpy()))
    out = np.array(img, np.float64)
    H, W = out.shape
    for i, (a, b) in enumerate(zip(s_w, e_w)):
        pc = np.stack([lie_np.pose_transform_point(p_cw, q_cw, x)
                       for x in (a, b)])
        if (pc[:, 2] < 0.5).any():
            continue
        uv = camera.pixel_from_normalized(
            rig.intr, torch.tensor(pc[:, :2] / pc[:, 2:3])).numpy()
        lo = np.floor(np.clip(uv.min(0) - 4, 0, [W - 1, H - 1])).astype(int)
        hi = np.ceil(np.clip(uv.max(0) + 4, 0, [W - 1, H - 1])).astype(int)
        if (hi <= lo).any():
            continue
        yy, xx = np.mgrid[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        d = uv[1] - uv[0]
        t_img = ((xx - uv[0, 0]) * d[0] + (yy - uv[0, 1]) * d[1]) \
            / max(float(d @ d), 1e-12)
        t = np.clip(t_img, 0.0, 1.0)
        dist = np.hypot(xx - uv[0, 0] - t * d[0], yy - uv[0, 1] - t * d[1])
        # the image parameter back to the world segment's (perspective)
        tw = t * pc[0, 2] / (t * pc[0, 2] + (1 - t) * pc[1, 2])
        rng = np.random.default_rng(1000 + i)
        amp, phase = rng.normal(size=3), rng.uniform(size=3)
        wave = sum(amp[j] * np.cos(2 * np.pi * ((j + 1) * tw + phase[j]))
                   for j in range(3)) / np.abs(amp).sum()
        level = 150.0 + 105.0 * wave
        w = np.clip((1.0 - dist) / 3.0 + 0.5, 0.0, 1.0)
        sub = out[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        sub[:] = sub * (1 - w) + w * level
    return np.clip(out, 0.0, 255.0)


def carried_share(prev, cur, strokes):
    """The share of a frame's segments that carry an id of the frame
    before. With `strokes`, a segment also counts when the other edge of
    its stroke does: LSD returns the two edges of a bright stroke as two
    antiparallel segments with the same intensity profile, and the
    tracker's greedy matcher (the JAX package's) gives each previous
    segment to one current one, so the second edge keeps its id only
    when its best match is the other previous edge."""
    import numpy as np

    ids = {p.id for p in prev}

    def edges(a):
        da = np.array([a.ex - a.sx, a.ey - a.sy])
        out = [a]
        for b in cur:
            db = np.array([b.ex - b.sx, b.ey - b.sy])
            if b is not a and da @ db < -0.995 * np.linalg.norm(da) \
                    * np.linalg.norm(db) \
                    and np.linalg.norm(a.center - b.center) < 6.0:
                out.append(b)
        return out if strokes else [a]

    return sum(any(e.id in ids for e in edges(s)) for s in cur) \
        / max(len(cur), 1)


def line_truth_cos(est, seq, s_w, e_w):
    """For each line with a valid orth: |cos| between its direction and
    that of the world segment its newest left observation lies on (the
    least mean endpoint distance to the segment's projected line, in
    that frame's true left camera)."""
    import numpy as np
    import torch

    from dynamic_vins_tpu_torch.geometry import lie_np, lines

    lm = est.lines
    ft = seq.frame_times.numpy()
    rig = seq.rig
    out = []
    for slot in np.flatnonzero(lm.active & lm.orth_valid):
        f = int(np.flatnonzero(lm.has_obs[slot])[-1])
        k = int(np.argmin(np.abs(ft - est.timestamps[f])))
        p_cw, q_cw = lie_np.pose_inverse(*lie_np.pose_compose(
            seq.gt_p[k].numpy(), seq.gt_q[k].numpy(), rig.p_bc.numpy(),
            rig.q_bc.numpy()))
        best, best_d = None, np.inf
        for a, b in zip(s_w, e_w):
            pa = lie_np.pose_transform_point(p_cw, q_cw, a)
            pb = lie_np.pose_transform_point(p_cw, q_cw, b)
            n = np.cross(pa, pb)
            den = max(np.hypot(n[0], n[1]), 1e-12)
            d = (abs(n @ lm.s[slot, f]) + abs(n @ lm.e[slot, f])) / den
            if d < best_d:
                best, best_d = b - a, d
        _, d_est = lines.orth_to_plucker(torch.tensor(lm.orth[slot]))
        d_est = d_est.numpy()
        out.append(abs(float(d_est @ best)) / (np.linalg.norm(d_est)
                                               * np.linalg.norm(best)))
    return out


def linepoint_check(torch, dev, seq):
    """Phase 15's float64 replay check: both steps with lines at the
    slice's widths on the scene's feature-domain frames, each branch's
    replay against the eager step."""
    import numpy as np

    from dynamic_vins_tpu_torch.estimator import step_check
    from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                            EstimatorConfig)
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import obs_capacity
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    cfg = VioConfig()
    F = cfg.num_frames
    s_w, e_w = line_segments_world()
    frames = frontend_sim.make_frames(seq, max_feats=N_FEAT,
                                      pixel_noise=0.5)[:LINE_CHECK_FRAMES]
    frames = [(f._replace(lines=frontend_sim.line_obs_for_frame(
        seq, k, s_w, e_w, np.random.default_rng(100 + k))), imu)
        for k, (f, imu) in enumerate(frames)]
    pr, qr = seq.rig.right_extrinsics()
    p_bc = np.stack([seq.rig.p_bc.numpy(), pr.numpy()])
    q_bc = np.stack([seq.rig.q_bc.numpy(), qr.numpy()])
    res = {}
    for pipelined in (False, True):
        est = Estimator(EstimatorConfig(
            num_frames=F, obs_capacity=obs_capacity(cfg),
            pipelined=pipelined, use_line=True, dtype=torch.float64),
            p_bc, q_bc, device=dev)
        est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                             sim.state_at(seq.frame_times[0])[2].numpy())
        outs = [est.process_frame(f, imu) for f, imu in frames]
        outs = [o for o in outs if o is not None] + est.flush()
        graph = est._pipe if pipelined else est._mega
        nl = int(est.lines.orth_valid.sum())
        if est.failed or len(outs) != LINE_CHECK_FRAMES or nl < MIN_LINES \
                or sum(graph.replays.values()) != LINE_CHECK_FRAMES - F:
            fail(f"linepoint check (pipelined {pipelined}): failed "
                 f"{est.failed}, {len(outs)} outputs, {nl} lines, "
                 f"{graph.replays} replays")
        for key in (True, False):
            eager = graph.fn(key, graph.inputs)
            replay = graph.replay(key)
            agree = step_check.agreement(est._consts, eager, replay)
            res[f"pipelined {pipelined} keyframe {key}"] = dict(
                agree, segments=graph.segments(key),
                host_syncs=graph.host_syncs(key))
            if not (agree["masks_equal"]
                    and agree["pos_m"] <= REPLAY_POS_ATOL_M
                    and agree["orth"] <= REPLAY_POS_ATOL_M):
                fail(f"LinePoint replay differs from the eager step "
                     f"(pipelined {pipelined}, keyframe {key}): {agree}")
            if graph.host_syncs(key) != 3:
                fail(f"LinePoint step (pipelined {pipelined}, keyframe "
                     f"{key}): {graph.host_syncs(key)} host syncs a "
                     f"replay, expected 3")
        del est, graph
        torch.cuda.empty_cache()
    print("linepoint check: float64, replay vs eager:", json.dumps(res),
          flush=True)


def linepoint_phase(torch, dev, seq, imgs, imus):
    """Phase 15 (see the module docstring)."""
    import numpy as np

    s_w, e_w = line_segments_world()
    t0 = time.perf_counter()
    limgs = [tuple(draw_strokes(imgs[k][c], seq, k, c, s_w, e_w)
                   for c in (0, 1)) for k in range(FRAMES)]
    print(f"linepoint: {N_SEGMENTS} world segments drawn into "
          f"{FRAMES} stereo frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    r = run_slice(torch, dev, seq, limgs, imus, "linepoint", use_line=True)
    segs, system = r["segs"], r["system"]
    est = system.estimator
    counts = [len(x) for x in segs]
    carried = [carried_share(segs[k - 1], segs[k], False)
               for k in range(1, FRAMES)]
    strokes = [carried_share(segs[k - 1], segs[k], True)
               for k in range(1, FRAMES)]
    cos = line_truth_cos(est, seq, s_w, e_w)
    good = sum(c > LINE_COS for c in cos)
    print(f"linepoint: segments a left image {json.dumps(counts)}, share "
          f"carrying an id of the frame before "
          f"{json.dumps([round(c, 3) for c in carried])} (mean "
          f"{sum(carried) / len(carried):.3f}), counting the stroke's other "
          f"edge {json.dumps([round(c, 3) for c in strokes])}, lines with a "
          f"valid orth {len(cos)}, within cos {LINE_COS} of their world "
          f"segment {good}", flush=True)
    if min(counts) < MIN_SEGMENTS:
        fail(f"linepoint: a left image with {min(counts)} segments "
             f"(< {MIN_SEGMENTS})")
    if sum(carried) / len(carried) < 0.5 or min(strokes) < 0.5:
        fail(f"linepoint: segments carrying an id of the frame before: "
             f"mean {sum(carried) / len(carried):.2f}, a frame's strokes "
             f"{min(strokes):.2f} (gates 0.5)")
    if len(cos) < MIN_LINES or good < 0.6 * len(cos):
        fail(f"linepoint: {len(cos)} lines with a valid orth, {good} "
             f"within cos {LINE_COS} of the truth")
    if any(r["graph"].host_syncs(k) != 3 for k in r["graph"].chains):
        fail("linepoint: a megastep replay with other than 3 host syncs")
    launches = r["launches"]
    del r, system, est
    pipe = run_slice(torch, dev, seq, limgs, imus, "linepoint-pipelined",
                     frames=LINE_PIPE_FRAMES, pipelined=True, use_line=True)
    linepoint_check(torch, dev, seq)
    return dict(launches={n: launches[n] + pipe["launches"][n]
                          for n in ("lk_level", "lk_track")})


# ---------------------------------------------------------------------------
# phases 16-18: the online perception nets
# ---------------------------------------------------------------------------
def _net_inputs(imgs):
    """The nets phase's inputs: the slice's frame 10 (left, right), frame
    11 (left), and 16 boxes of 64 x 128 px on frame 10's left image (a 4
    x 4 grid; those of the last row and column reach past the image's
    edge, so their crops are clamped)."""
    import numpy as np

    left = imgs[10][0]
    H, W = left.shape
    boxes = np.array([[x, y, x + 64, y + 128]
                      for y in np.linspace(0, H - 60, 4)
                      for x in np.linspace(0, W - 40, 4)], np.float64)
    return left, imgs[10][1], imgs[11][0], boxes


def nets_phase(torch, dev, card, imgs, rig):
    """Phase 16 (see the module docstring)."""
    from dynamic_vins_tpu_torch.models import layers, pretrained

    left, right, nxt, boxes = _net_inputs(imgs)
    hw = left.shape
    intr = [float(v) for v in rig.intr[:4]]
    made = {}
    for task in ("solo", "det3d", "stereo", "flow", "reid"):
        made[task] = [pretrained.load_online(task, hw, intr, device=d)
                      for d in (dev, "cpu")]
    print(f"nets: {hw[1]}x{hw[0]}, float32, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}; card {card}",
          flush=True)
    reid = made["reid"][0]
    crops = reid.crops(left, boxes)
    norm = lambda w, img: layers.normalize_image(img, w.dtype, w.device)
    # (raw outputs of one wrapper, timed device call, tolerance kind)
    raw = dict(
        solo=lambda w: list(w.model(norm(w, left))),
        det3d=lambda w: [t for lv in w.model(norm(w, left)) for t in lv],
        stereo=lambda w: [w.run(left, right)],
        flow=lambda w: [w(left, nxt)],
        reid=lambda w: [w.embed(crops)])
    timed = dict(
        solo=lambda w: w.run(left), det3d=lambda w: w.run(left),
        stereo=lambda w: w.run(left, right), flow=lambda w: w(left, nxt),
        reid=lambda w: w.embed(crops))
    out = {}
    for task, (card_net, cpu_net) in made.items():
        with torch.no_grad():
            a = [t.cpu() for t in raw[task](card_net)]
            b = raw[task](cpu_net)
        if task in ("stereo", "flow"):
            err = max(float((x - y).abs().max()) for x, y in zip(a, b))
            tol, what = NET_PX_ATOL, "px"
        else:
            err = max(float((x - y).abs().max() / y.abs().max().clamp_min(
                1e-6)) for x, y in zip(a, b))
            tol, what = NET_RTOL, "relative to the output's scale"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _timed(torch, lambda: timed[task](card_net), 20)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        shapes = [tuple(t.shape) for t in a]
        print(f"nets: {task}: card vs CPU max |diff| {err:.3e} {what} "
              f"(tolerance {tol}), outputs {shapes}; {ms:.3f} ms a call "
              f"(CUDA events, 20 calls after 5), peak device memory "
              f"{peak:.1f} MiB above the {base / 2**20:.1f} MiB held "
              f"before; {card}", flush=True)
        if not err <= tol:
            fail(f"nets: {task}: the card's raw outputs differ from the "
                 f"CPU's by {err} (tolerance {tol} {what})")
        out[task] = dict(ms=ms, peak_mib=peak, err=err)
    return out


def accuracy_phase(torch, dev):
    """Phase 17 (see the module docstring)."""
    import numpy as np

    from dynamic_vins_tpu_torch.models import layers, pretrained
    from dynamic_vins_tpu_torch.models.raft import RAFT
    from dynamic_vins_tpu_torch.models.reid import ReidNet
    from dynamic_vins_tpu_torch.models.stereo_net import StereoNet
    from dynamic_vins_tpu_torch.training import data

    hw = ACC_HW
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    nchw = lambda a: ((put(a) / 255.0 - 0.45) / 0.225).permute(0, 3, 1, 2)
    net = lambda m, task: pretrained.prepare(
        m, pretrained.weights_path(task), torch.float32, dev)
    # tests/test_shipped_weights.py: the training CLI's task builder draws
    # one batch (its init batch) before the fresh one it scores
    rng = np.random.default_rng(ACC_SEED)
    data.stereo_batch(rng, 2, hw, 32)
    left, right, disp, valid = data.stereo_batch(rng, 2, hw, 32)
    with torch.no_grad():
        pred = net(StereoNet(max_disp=32), "stereo")(nchw(left),
                                                     nchw(right))
    err = (pred - put(disp)).abs()
    sl1 = torch.where(err < 1.0, 0.5 * err * err, err - 0.5)
    w = put(valid).float()
    stereo = float((sl1 * w).sum() / w.sum().clamp_min(1.0))
    rng = np.random.default_rng(ACC_SEED)
    data.flow_batch(rng, 1, hw)
    img1, img2, flow, valid = data.flow_batch(rng, 1, hw)
    with torch.no_grad():
        pred = net(RAFT(iters=4), "flow")(nchw(img1), nchw(img2))
    err = (pred.permute(0, 2, 3, 1) - put(flow)).abs().sum(-1)
    w = put(valid).float()
    flow_epe = float((err * w).sum() / w.sum().clamp_min(1.0))
    im, lab = data.reid_batch(np.random.default_rng(7), num_ids=4, views=4,
                              hw=(64, 32))
    with torch.no_grad():
        emb = net(ReidNet(), "reid")(nchw(im.astype(np.float32)))
    emb = emb.cpu().numpy()
    sim_ = emb @ emb.T
    same = lab[:, None] == lab[None, :]
    off = ~np.eye(len(lab), dtype=bool)
    sep = float(sim_[same & off].mean() - sim_[~same].mean())
    print(f"accuracy: {hw[1]}x{hw[0]}, seed {ACC_SEED}, on the card: stereo "
          f"smooth-L1 EPE {stereo:.4f} px (gate < {ACC_STEREO_PX}), flow "
          f"EPE {flow_epe:.4f} px (gate < {ACC_FLOW_PX}), ReID intra - "
          f"inter cosine {sep:.4f} (gate > {ACC_REID_SEP})", flush=True)
    if not (stereo < ACC_STEREO_PX and flow_epe < ACC_FLOW_PX
            and sep > ACC_REID_SEP):
        fail("accuracy: a shipped net misses its gate")
    return dict(stereo_epe=stereo, flow_epe=flow_epe, reid_sep=sep)


def online_phase(torch, dev, seq, dframes, imus):
    """Phase 18 (see the module docstring)."""
    import numpy as np

    from dynamic_vins_tpu_torch.io import perception
    from dynamic_vins_tpu_torch.models import pretrained
    from dynamic_vins_tpu_torch.models.solov2 import OnlineDetector2D
    from dynamic_vins_tpu_torch.ops import lk_level as K
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import FrameInput, System
    from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig

    cfg = slice_config(seq.rig, VioConfig())
    cfg.slam = SlamMode.DYNAMIC
    cfg.det2d_online = cfg.det3d_online = cfg.stereo_online = True
    cfg.use_dense_flow = cfg.use_reid = True
    cfg.det2d_score_thresh = ONLINE_DET2D_THRESH
    cfg.stereo_weights = pretrained.weights_path("stereo")
    cfg.flow_weights = pretrained.weights_path("flow")
    cfg.reid_weights = pretrained.weights_path("reid")
    system = System(cfg, output_prefix=str(REPO / "output"
                                           / "chip_smoke_online"),
                    device=dev, dtype=torch.float32)
    est = system.estimator
    # an untrained head's argmax favours a few classes (seed 0's are none
    # of the dynamic ones on this scene): take the first seed whose
    # SOLOv2 finds a dynamic-class instance on frame 0, so that MOT, ReID
    # and the instance path run
    for seed in range(ONLINE_SEEDS):
        det = OnlineDetector2D((cfg.image_height, cfg.image_width),
                               score_thresh=cfg.det2d_score_thresh,
                               seed=seed, device=dev)
        if any(int(l) in perception.COCO_DYNAMIC_IDS
               for l in det(dframes[0].img_left).labels):
            system.det2d = det
            break
    else:
        fail(f"online: no SOLOv2 seed below {ONLINE_SEEDS} finds a "
             f"dynamic-class instance on frame 0")
    print(f"online: {seq.rig.width}x{seq.rig.height} stereo+IMU DYNAMIC, "
          f"every net online (SOLOv2 seeded at {seed} and FCOS3D at 0, at "
          f"the System's shapes, score threshold "
          f"{cfg.det2d_score_thresh}; stereo, RAFT and ReID shipped), "
          f"window {cfg.window_size}, estimator dtype {est.dtype}, "
          f"{FRAMES} frames", flush=True)
    est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                         sim.state_at(seq.frame_times[0])[2].numpy())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, [est._mega, est.im.solve_graph])
    outs, flows, dyn_frames, inst_frames, masks = [], 0, 0, 0, []
    for k, df in enumerate(dframes):
        if k == STEADY_FROM:
            torch.cuda.synchronize()
            system.reset_timers()
            t_steady = time.perf_counter()
        fi = FrameInput(float(seq.frame_times[k]), df.img_left,
                        df.img_right, imu=imus[k])
        outs.append(system.process(fi))
        flows += system.last_flow is not None
        dyn = [int(l) in perception.COCO_DYNAMIC_IDS for l in fi.seg.labels]
        dyn_frames += any(dyn)
        inst_frames += bool(system._last_dets)
        masks.append((len(fi.seg.masks), sum(dyn), len(fi.boxes3d)))
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t_steady) / (FRAMES
                                                         - STEADY_FROM)
    launches = dict(lk_level=K.launches, plain_levels=K.plain_levels,
                    **{f"lk_track_r{r}": n for r, n
                       in K.track_launches_by_radius.items()})
    counts = {k: v for k, v in system.timer.counts.items()
              if k.startswith("pe.")}
    stages = system.close()
    peak = torch.cuda.max_memory_allocated() / 2**20
    steady = FRAMES - STEADY_FROM
    print(f"online: per frame (detections, dynamic ones, 3D boxes) "
          f"{json.dumps(masks)}; {dyn_frames} frames with a dynamic "
          f"detection, {inst_frames} with instances, {flows} with a flow "
          f"field", flush=True)
    print(f"online: kernel launches {json.dumps(launches)}; net calls over "
          f"the steady frames {json.dumps(counts)}", flush=True)
    want = dict(lk_level=0, plain_levels=0,
                lk_track_r10=FRAMES + 1, lk_track_r8=2 * inst_frames)
    if launches != want:
        fail(f"online: LK launches {launches}, expected {want} (the "
             f"temporal track on frame 0 only, then the flow field)")
    dyn_steady = sum(m[1] > 0 for m in masks[STEADY_FROM:])
    want_calls = {"pe.det2d": steady, "pe.det3d": steady,
                  "pe.stereo": steady, "pe.flow": steady}
    if dyn_steady:
        want_calls["pe.reid"] = dyn_steady
    if counts != want_calls or flows != FRAMES - 1:
        fail(f"online: net calls {counts}, expected {want_calls}; flow "
             f"fields {flows}, expected {FRAMES - 1}")
    if any(o is None for o in outs) or est.failed or not all(
            np.isfinite(np.concatenate([o.p, o.q, o.v])).all()
            for o in outs):
        fail("online: a frame without an output, a non-finite output, or "
             "estimator failure")
    inst = est.get_instance_states()
    if not all(np.isfinite(np.concatenate([s["p"], s["q"], s["v"]])).all()
               for s in inst.values()):
        fail("online: a non-finite instance state")
    p = np.stack([o.p for o in outs])
    ate = frontend_sim.ate_rmse(p, seq.gt_p.numpy())
    split = {k: stages.get(k) for k in ("perception", "pe.det2d",
                                        "pe.det3d", "pe.stereo", "pe.flow",
                                        "pe.reid", "frontend",
                                        "fe.dispatch", "instances",
                                        "backend", "be.step", "output")}
    print(f"online: steady ms/frame (frames {STEADY_FROM}-{FRAMES - 1}) "
          f"{steady_ms:.2f}, ego ATE {ate:.4f} m (printed, not gated: the "
          f"untrained detector's instances), {len(inst)} instances, peak "
          f"device memory {peak:.1f} MiB", flush=True)
    print(f"online: stage means (ms, steady frames; pe.flow is the "
          f"dispatch, its device time lands in the next stage that "
          f"waits):", json.dumps(split), flush=True)
    print("online: all stage means:", json.dumps(stages), flush=True)
    return dict(launches=launches, steady_ms=steady_ms)


def circle_pose(t, w, radius=LOOP_RADIUS_M, h=LOOP_HEIGHT_M):
    """tests/test_loop_live.py's circle at time t: (p, R_wb, v), body x
    at the cloud's centre, z up."""
    import numpy as np

    th = w * t
    p = np.array([radius * np.cos(th), radius * np.sin(th), h])
    x = -np.array([np.cos(th), np.sin(th), 0.0])
    z = np.array([0.0, 0.0, 1.0])
    R_wb = np.stack([x, np.cross(z, x), z], axis=1)
    v = radius * w * np.array([-np.sin(th), np.cos(th), 0.0])
    return p, R_wb, v


def circle_imu(t0, t1, w, rng, hz, radius=LOOP_RADIUS_M, acc_noise=0.05,
               gyr_noise=0.005):
    """tests/test_loop_live.py's analytic IMU samples over [t0, t1] with
    noise: (acc [n+1,3], gyr, dt [n])."""
    import numpy as np

    n = max(int(round((t1 - t0) * hz)), 2)
    tt = np.linspace(t0, t1, n + 1)
    acc, gyr = [], []
    for t in tt:
        _, R_wb, _ = circle_pose(t, w, radius)
        a_w = -w * w * radius * np.array([np.cos(w * t), np.sin(w * t),
                                          0.0])
        acc.append(R_wb.T @ (a_w + np.array([0.0, 0.0, GRAVITY]))
                   + rng.normal(scale=acc_noise, size=3))
        gyr.append(R_wb.T @ np.array([0.0, 0.0, w])
                   + rng.normal(scale=gyr_noise, size=3))
    return np.stack(acc), np.stack(gyr), np.diff(tt)


def loop_scene(torch, dev, rig, frames, lap, period, landmarks, sigma,
               imu_hz):
    """A lap around tests/test_loop_live.py's landmark cloud (seed 3):
    per frame (t, left, right, imu, disparity from the renderer's
    depth) and the true (p, q, v)."""
    import numpy as np

    from dynamic_vins_tpu_torch.geometry import lie_np
    from dynamic_vins_tpu_torch.sim import render

    rng = np.random.default_rng(LOOP_SEED)
    lms = torch.tensor(rng.uniform(-2.5, 2.5, size=(landmarks, 3))
                       * np.array([1.0, 1.0, 0.8]), device=dev)
    inten = render.make_intensities(landmarks, seed=LOOP_SEED)
    w = 2 * np.pi / period
    ts = np.arange(frames) * (period / lap)
    rig_d = rig.to(dev)
    pr, _ = rig.right_extrinsics()
    baseline = float(torch.linalg.vector_norm(pr - rig.p_bc))
    fx = float(rig.intr.fx)
    out, truth = [], []
    for k, t in enumerate(ts):
        p, R_wb, v = circle_pose(t, w)
        q = lie_np.matrix_to_quat(R_wb)
        pt, qt = (torch.tensor(a, device=dev) for a in (p, q))
        il, ir = (render.render_frame(rig_d, pt, qt, lms, inten, cam=c,
                                      sigma=sigma).cpu().numpy()
                  for c in (0, 1))
        dep = render.render_depth(rig_d, pt, qt, lms, cam=0).cpu().numpy()
        disp = np.where(np.isfinite(dep) & (dep > 0.1),
                        fx * baseline / np.maximum(dep, 0.1), 0.0)
        imu = circle_imu(ts[k - 1], t, w, rng, imu_hz) if k else None
        out.append((float(t), il, ir, imu, disp))
        truth.append((p, q, v))
    return out, truth


def loop_config(rig, live, pipelined=False, **fields):
    """A RAW stereo+IMU VioConfig (defaults) with loop closure."""
    from dynamic_vins_tpu_torch.utils.config import VioConfig

    cfg = slice_config(rig, VioConfig())
    cfg.use_loop_closure = True
    cfg.loop_live_correction = live
    cfg.loop_keyframe_stride = LOOP_STRIDE
    cfg.loop_min_gap = LOOP_MIN_GAP
    cfg.loop_prox_radius = LOOP_PROX_M
    cfg.pipelined = pipelined
    for k, v in fields.items():
        setattr(cfg, k, v)
    return cfg


def loop_ref_config(rig, live):
    """tests/test_loop_live.py's System settings on loop_config's."""
    return loop_config(rig, live, window_size=7, max_cnt=120, min_dist=12,
                       loop_keyframe_stride=2,
                       intrinsics_right=[float(v) for v in rig.intr[:4]])


def run_loop(torch, dev, name, cfg, frames, truth, steady_from=STEADY_FROM,
             dtype=None):
    """Drive the System with loop closure over the frames, counts set to
    0 just before and read just after. Fails on a launch or replay
    count, a non-finite output, a missing or disordered output (the
    trajectory file holds every frame once, in order, the frames a
    pipelined correction drains included), or a loop file whose rows
    are not the keyframes. Returns the counts, the edges, the final
    position error and the timings."""
    import numpy as np

    from dynamic_vins_tpu_torch.io.writers import read_tum
    from dynamic_vins_tpu_torch.ops import lk_level as K
    from dynamic_vins_tpu_torch.system import FrameInput, System

    prefix = REPO / "output" / f"chip_smoke_{name}"
    system = System(cfg, output_prefix=str(prefix), device=dev,
                    dtype=dtype or torch.float32)
    est = system.estimator
    est.set_initial_pose(*truth[0])
    graph = est._pipe if cfg.pipelined else est._mega
    captures = []
    capture = graph.capture
    graph.capture = lambda key: (captures.append(key), capture(key))[1]
    steady_calls = []
    process_frame = est.process_frame

    def counted(frame, imu=None, instances=None):
        steady_calls.append(est.initialized
                            and est.frame_count == est.cfg.num_frames - 1)
        return process_frame(frame, imu, instances=instances)

    est.process_frame = counted
    loop_ms, corrections = [], []
    loop_keyframe = system._loop_keyframe

    def timed(fi, out):
        n_kf, n_edges = len(system.loop_closer.db), \
            len(system.loop_closer.edges)
        t0 = time.perf_counter()
        drained = loop_keyframe(fi, out)
        if len(system.loop_closer.db) > n_kf:
            loop_ms.append(1e3 * (time.perf_counter() - t0))
        if len(system.loop_closer.edges) > n_edges:
            corrections.append((len(steady_calls) - 1, len(drained)))
        return drained

    system._loop_keyframe = timed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K, [graph])
    outs = []
    for k, (t, il, ir, imu, disp) in enumerate(frames):
        if k == steady_from:
            torch.cuda.synchronize()
            system.reset_timers()
            t_steady = time.perf_counter()
        out = system.process(FrameInput(t, il, ir, imu=imu, disparity=disp))
        if out is not None:
            outs.append(out)
    outs += system.drain()
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t_steady) / (len(frames)
                                                         - steady_from)
    launches = dict(lk_level=K.launches, lk_track=K.track_launches,
                    plain_levels=K.plain_levels)
    replays = sum(graph.replays.values())
    steady = sum(steady_calls)
    closer = system.loop_closer
    orb_img = torch.as_tensor(frames[0][1], dtype=torch.float32,
                              device=dev)
    orb_ms = _timed(torch, lambda: closer._orb(orb_img), 20)
    pgo_ms = _timed(torch, closer.optimize, 3) if closer.edges else None
    stages = system.close()
    peak = torch.cuda.max_memory_allocated() / 2**20
    n = len(frames)
    if launches != dict(lk_level=0, lk_track=2 * n, plain_levels=0):
        fail(f"{name}: LK kernel launches {launches}, expected lk_track "
             f"{2 * n}, no lk_level launch and no plain level")
    if replays != steady or len(captures) > 2:
        fail(f"{name}: {replays} step replays for {steady} steady frames, "
             f"{len(captures)} captures (expected one a steady frame and "
             f"one capture a branch)")
    t_file, p_file, _ = read_tum(str(prefix) + "_ego_tum.txt")
    times = np.array([f[0] for f in frames])
    if len(t_file) != n or not np.allclose(t_file, times, rtol=0,
                                           atol=1e-6) or (
            not cfg.pipelined and [o.timestamp for o in outs]
            != list(times)):
        fail(f"{name}: the trajectory does not hold one pose a frame in "
             f"order ({len(t_file)} rows, {len(outs)} outputs returned)")
    if est.failed or not np.isfinite(p_file).all() or not all(
            np.isfinite(np.concatenate([o.p, o.q, o.v])).all()
            for o in outs):
        fail(f"{name}: non-finite output or estimator failure")
    edges = [(e.i, e.j, e.n_inliers) for e in closer.edges]
    if edges:
        t_loop, p_loop, _ = read_tum(str(prefix) + "_ego_tum_loop.txt")
        t_kf = [kf.timestamp for kf in closer.db.keyframes]
        if len(t_loop) != len(t_kf) or not np.allclose(
                t_loop, t_kf, rtol=0, atol=1e-6) \
                or not np.isfinite(p_loop).all():
            fail(f"{name}: the loop file's rows are not the keyframes")
    errs = np.linalg.norm(p_file - np.stack([t[0] for t in truth]), axis=1)
    err = float(errs[-1])
    print(f"{name}: {n} frames, {len(closer.db)} keyframes, loop edges "
          f"(i, j, inliers) {edges}, corrections (call, frames drained) "
          f"{corrections}; final position error {err:.4f} m; kernel "
          f"launches {json.dumps(launches)}, step replays {replays} for "
          f"{steady} steady frames, captures {len(captures)} "
          f"(keyframe branch True/False: {captures})", flush=True)
    print(f"{name}: steady ms/frame (frames {steady_from}-{n - 1}) "
          f"{steady_ms:.2f}; loop stage ms a keyframe (host clock) mean "
          f"{np.mean(loop_ms):.2f} max {np.max(loop_ms):.2f} over "
          f"{len(loop_ms)}; ORB ms a keyframe (CUDA events, "
          f"{closer.cfg.n_features} features, {closer.cfg.n_levels} "
          f"levels) {orb_ms:.3f}; pose-graph solve ms at K = "
          f"{len(closer.db)} (CUDA events, optimize()) "
          f"{'none' if pgo_ms is None else f'{pgo_ms:.2f}'}; peak device "
          f"memory {peak:.1f} MiB", flush=True)
    print(f"{name}: stage means (ms, steady frames):", json.dumps(stages),
          flush=True)
    print(f"{name}: loop stage ms per keyframe, in order:",
          json.dumps([round(t, 2) for t in loop_ms]), flush=True)
    return dict(launches=launches, edges=edges, err=err, errs=errs,
                steady_ms=steady_ms, corrections=corrections)


def pgo_ring(nodes=PGO_NODES, loops=PGO_LOOPS, laps=2, radius=20.0,
             drift=0.01, seed=SEED):
    """Two laps of a ring, `nodes` poses: odometry edges with noise,
    integrated into the initial guess (it drifts), and `loops` exact
    edges from first-lap nodes to the second lap's revisits."""
    import numpy as np

    from dynamic_vins_tpu_torch.geometry import lie_np

    rng = np.random.default_rng(seed)
    per = nodes // laps
    th = 2 * np.pi * np.arange(nodes) / per
    gt_p = np.stack([radius * np.cos(th), radius * np.sin(th),
                     0.5 * np.sin(th)], -1)
    yaw = th + np.pi / 2
    gt_q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)],
                    -1)

    def rel(i, j):
        return lie_np.pose_compose(*lie_np.pose_inverse(gt_p[i], gt_q[i]),
                                   gt_p[j], gt_q[j])

    edges, rels = [], []
    for k in range(nodes - 1):
        rp, rq = rel(k, k + 1)
        a = rng.normal(scale=drift, size=3)
        n = np.linalg.norm(a)
        dq = np.concatenate([[np.cos(n / 2)], np.sin(n / 2) * a / n])
        edges.append((k, k + 1))
        rels.append((rp + rng.normal(scale=drift, size=3),
                     lie_np.quat_multiply(rq, dq)))
    for m in range(loops):
        i = m * (per // loops)
        edges.append((i, per + i))
        rels.append(rel(i, per + i))
    p, q = [gt_p[0]], [gt_q[0]]
    for k in range(nodes - 1):
        p2, q2 = lie_np.pose_compose(p[-1], q[-1], *rels[k])
        p.append(p2)
        q.append(q2)
    return np.stack(p), np.stack(q), edges, rels


def pgo_phase(torch, dev):
    """Phase 19c: the pose graph at the database's capacity, in float64
    (the loop closer's float type) and, for the record, in float32."""
    import numpy as np

    from dynamic_vins_tpu_torch.loop import LoopClosureConfig
    from dynamic_vins_tpu_torch.solver import pose_graph as pg

    p, q, edges, rels = pgo_ring()
    lc = LoopClosureConfig()
    n_odom = PGO_NODES - 1

    def graph(device, dtype):
        # the loop closer's edge weights (odometry 1, loop 10)
        g = pg.make_graph(p, q, edges, rels, device=device, dtype=dtype)
        s = torch.full((len(edges),), lc.loop_info, dtype=dtype)
        s[:n_odom] = lc.odom_info
        return g._replace(sqrt_info=g.sqrt_info * s.to(device)[:, None, None])

    cfg = pg.PgoConfig()
    t0 = time.perf_counter()
    ref, ref_info = pg.solve(graph("cpu", torch.float64), cfg)
    cpu_s = time.perf_counter() - t0
    ref_p = ref.p.numpy()
    out = {}
    for dtype in (torch.float64, torch.float32):
        g = graph(dev, dtype)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, info = pg.solve(g, cfg)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        solve_ms = _timed(torch, lambda: pg.solve(g, cfg), 3)
        build_ms = _timed(torch, lambda: pg.build_normal_equations(g, cfg),
                          10)
        c0, c1 = float(info["initial_cost"]), float(info["final_cost"])
        gap = float(np.abs(res.p.double().cpu().numpy() - ref_p).max())
        out[str(dtype)] = dict(gap=gap, solve_ms=solve_ms,
                               build_ms=build_ms, peak=peak, c0=c0, c1=c1)
        print(f"loop-pgo {dtype}: {PGO_NODES} nodes (two laps), "
              f"{len(edges)} edges ({PGO_LOOPS} loop edges, weight "
              f"{lc.loop_info}), dense [{6 * PGO_NODES}]^2 system: cost "
              f"{c0:.4f} -> {c1:.6f} (CPU float64 "
              f"{float(ref_info['final_cost']):.6f}); max |dp| from the "
              f"CPU's float64 solve {gap:.3e} m; solve ms (12 LM "
              f"iterations, CUDA events) {solve_ms:.2f}, "
              f"build_normal_equations ms {build_ms:.3f}, peak device "
              f"memory above the run's {peak:.1f} MiB", flush=True)
    print(f"loop-pgo: CPU float64 solve {cpu_s:.1f} s", flush=True)
    f64 = out[str(torch.float64)]
    if not f64["c1"] < f64["c0"]:
        fail(f"loop-pgo: final cost {f64['c1']} not below {f64['c0']}")
    if not f64["gap"] < PGO_ATOL_M:
        fail(f"loop-pgo: the card's float64 solve {f64['gap']} m from the "
             f"CPU's")
    return out


def loop_phase(torch, dev, seq):
    """Phase 19 (see the module docstring)."""
    from dynamic_vins_tpu_torch.sim import render

    rig = seq.rig
    t0 = time.perf_counter()
    frames, truth = loop_scene(torch, dev, rig, LOOP_FRAMES, LOOP_LAP,
                               LOOP_LAP / LOOP_HZ, N_LANDMARKS,
                               BLOB_SIGMA_PX, 200.0)
    print(f"loop: rendered {LOOP_FRAMES} {rig.width}x{rig.height} stereo "
          f"frames with depth (lap {LOOP_LAP} frames at {LOOP_HZ} Hz, "
          f"{N_LANDMARKS} landmarks, blob sigma {BLOB_SIGMA_PX} px) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    live = run_loop(torch, dev, "loop", loop_config(rig, True), frames,
                    truth)
    off = run_loop(torch, dev, "loop-off", loop_config(rig, False), frames,
                   truth)
    print(f"loop: final position error with live correction "
          f"{live['err']:.4f} m, without {off['err']:.4f} m", flush=True)
    if not any(j - i >= LOOP_MIN_GAP for i, j, _ in live["edges"]):
        fail(f"loop: no loop edge with j - i >= {LOOP_MIN_GAP}")
    if not live["err"] < off["err"]:
        fail(f"loop: the live correction did not cut the final error "
             f"({live['err']} m against {off['err']} m)")
    pipe = run_loop(torch, dev, "loop-pipelined",
                    loop_config(rig, True, pipelined=True), frames, truth)
    if not pipe["edges"]:
        fail("loop-pipelined: no loop edge")
    pgo = pgo_phase(torch, dev)
    # tests/test_loop_live.py's protocol: 376x240, 45 frames, a 36-frame
    # lap, window 7, stride 2
    ref_rig = render.small_rig(0.5)
    frames, truth = loop_scene(torch, dev, ref_rig, LOOP_REF_FRAMES,
                               LOOP_REF_LAP, LOOP_REF_PERIOD, 220, 1.6,
                               100.0)
    runs = [live, off, pipe]
    # in float64, as the reference runs its test, then in float32. The
    # gate: the live run at least 2x closer to the truth than the
    # uncorrected one on the first frame after the first correction. The
    # reference's own gate, on the last frame, is printed: this 2.57 Hz
    # protocol's VIO wanders by 1-2 m and its error on the last frame
    # follows the rounding (see the module docstring)
    for dtype in (torch.float64, torch.float32):
        tag = "loop-ref" + ("" if dtype == torch.float64 else "-f32")
        ref_on = run_loop(torch, dev, tag, loop_ref_config(ref_rig, True),
                          frames, truth, dtype=dtype)
        ref_off = run_loop(torch, dev, tag + "-off",
                           loop_ref_config(ref_rig, False), frames, truth,
                           dtype=dtype)
        runs += [ref_on, ref_off]
        if not ref_on["corrections"]:
            fail(f"{tag}: no loop edge accepted")
        # the frame after the one whose output the first correction used
        c = ref_on["corrections"][0][0] + 1
        on_c, off_c = ref_on["errs"][c], ref_off["errs"][c]
        print(f"{tag}: estimator {dtype}; position error on frame {c}, "
              f"the first after the correction: live {on_c:.4f} m, "
              f"uncorrected {off_c:.4f} m (gate {LOOP_REF_GAIN}x); on the "
              f"last frame "
              f"(tests/test_loop_live.py's gate, printed): live "
              f"{ref_on['err']:.4f} m, uncorrected {ref_off['err']:.4f} m, "
              f"ratio {ref_off['err'] / ref_on['err']:.2f}; per frame, "
              f"live", json.dumps([round(float(e), 3)
                                   for e in ref_on["errs"]]),
              "uncorrected", json.dumps([round(float(e), 3)
                                         for e in ref_off["errs"]]),
              flush=True)
        if not on_c < off_c / LOOP_REF_GAIN:
            fail(f"{tag}: live {on_c} m on frame {c} not {LOOP_REF_GAIN}x "
                 f"below the uncorrected {off_c} m")
    return dict(runs=runs, pgo=pgo)


# ---------------------------------------------------------------------------
# phase 20: training the perception nets
# ---------------------------------------------------------------------------
def _train_loss(task):
    """tests/test_training.py's loss of `task` on a placed batch."""
    from dynamic_vins_tpu_torch.training import losses
    from dynamic_vins_tpu_torch.training.cli import _norm

    def stereo(m, b):
        l = losses.stereo_loss(m(_norm(b[0]), _norm(b[1])), b[2], b[3])
        return l, {}

    def flow(m, b):
        l = losses.flow_loss(m(_norm(b[0]), _norm(b[1])), b[2], b[3])
        return l, {}

    def solo(m, b):
        k, s, mf = m(_norm(b[0]))
        return losses.solo_loss(k, s, mf, b[1], b[2], b[3],
                                num_classes=8)[0], {}

    def det3d(m, b):
        return losses.fcos3d_loss(m(_norm(b[0])), b[1], num_classes=6)[0], {}

    def reid(m, b):
        return losses.triplet_loss(m(_norm(b[0])), b[1]), {}

    return dict(stereo=stereo, flow=flow, solo=solo, det3d=det3d,
                reid=reid)[task]


def training_gates_phase(torch, dev, card):
    """Phase 20a: tests/test_training.py's protocols on the card."""
    import numpy as np

    from dynamic_vins_tpu_torch.models.det3d import FCOS3D
    from dynamic_vins_tpu_torch.models.layers import seeded
    from dynamic_vins_tpu_torch.models.raft import RAFT
    from dynamic_vins_tpu_torch.models.reid import ReidNet
    from dynamic_vins_tpu_torch.models.solov2 import Solov2
    from dynamic_vins_tpu_torch.models.stereo_net import StereoNet
    from dynamic_vins_tpu_torch.training import TrainConfig, Trainer
    from dynamic_vins_tpu_torch.training import data
    from dynamic_vins_tpu_torch.training.cli import _norm

    grids = (12, 8, 6, 4)
    # (model, batch, lr, total_steps, steps after the first, gate ratio)
    protocols = dict(
        stereo=(StereoNet(max_disp=16, gen=seeded(0)),
                data.stereo_batch(np.random.default_rng(0), 2, (48, 64),
                                  16), 2e-3, 60, 39, 0.5),
        flow=(RAFT(iters=3, gen=seeded(0)),
              data.flow_batch(np.random.default_rng(1), 2, (48, 64), 3.0),
              1e-3, 40, 24, 0.8),
        solo=(Solov2(num_classes=8, grid_sizes=grids, gen=seeded(0)),
              data.seg_batch(np.random.default_rng(2), 2, (96, 128),
                             num_classes=8, grid_sizes=grids,
                             mask_hw=(24, 32)), 1e-3, 40, 19, 0.7),
        det3d=(FCOS3D(num_classes=6, gen=seeded(0)),
               data.det3d_batch(np.random.default_rng(3), 2, (96, 128),
                                num_classes=6), 1e-3, 40, 19, 0.7),
        reid=(ReidNet(embed_dim=32, gen=seeded(0)),
              data.reid_batch(np.random.default_rng(4), num_ids=4,
                              views=4, hw=(32, 16)), 1e-3, 60, 39, None))
    out = {}
    for task, (model, batch, lr, total, more, ratio) in protocols.items():
        init = sum(float(p.abs().sum()) for p in model.parameters())
        tr = Trainer(_train_loss(task), model,
                     TrainConfig(learning_rate=lr, total_steps=total),
                     device=dev)
        t0 = time.perf_counter()
        first, _ = tr.step(batch)
        for _ in range(more):
            last, _ = tr.step(batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        line = (f"train-gates: {task}: {more + 1} steps in {secs:.2f} s, "
                f"loss {first:.4f} -> {last:.4f} (the seeded init's sum "
                f"|w| {init:.6f})")
        if ratio is not None:
            print(f"{line} ({last / first:.3f}x, gate < {ratio}x); {card}",
                  flush=True)
            if not (np.isfinite(last) and last < ratio * first):
                fail(f"train-gates: {task} loss {first} -> {last}, not "
                     f"below {ratio}x")
        else:
            im, ids = batch
            with torch.no_grad():
                emb = tr.model(_norm(torch.from_numpy(im).to(dev)))
            emb = emb.cpu().numpy()
            d = 1.0 - emb @ emb.T
            same = ids[:, None] == ids[None, :]
            eye = np.eye(len(ids), dtype=bool)
            intra, inter = d[same & ~eye].mean(), d[~same].mean()
            print(f"{line}; cosine distance intra {intra:.4f}, inter "
                  f"{inter:.4f} (gate: inter - intra > 0.1); {card}",
                  flush=True)
            if not (np.isfinite(last) and inter > intra + 0.1):
                fail(f"train-gates: reid intra {intra} inter {inter}")
        out[task] = dict(first=first, last=last, s=secs)
    return out


def training_width_phase(torch, dev, card):
    """Phase 20b: the five CLI tasks at 96x128 and their recipes'
    batches, on fresh batches."""
    import math

    import numpy as np

    from dynamic_vins_tpu_torch.tools.train_shipped_weights import RECIPES
    from dynamic_vins_tpu_torch.training import TrainConfig, Trainer
    from dynamic_vins_tpu_torch.training import cli

    out = {}
    for task, (model_kw, steps, batch, lr) in RECIPES.items():
        model, loss_fn, next_batch = cli.build_task(
            task, TRAIN_HW, np.random.default_rng(SEED), batch, dev)
        t0 = time.perf_counter()
        batches = [next_batch() for _ in range(TRAIN_STEPS)]
        gen_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr = Trainer(loss_fn, model,
                     TrainConfig(learning_rate=lr, total_steps=steps),
                     device=dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        losses = []
        for i, bt in enumerate(batches):
            if i == TRAIN_TIMED_FROM:
                torch.cuda.synchronize()
                a.record()
            losses.append(tr.step(bt)[0])
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / (TRAIN_STEPS - TRAIN_TIMED_FROM)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"train-width: {task} (model {json.dumps(model_kw)}), "
              f"{TRAIN_HW[1]}x{TRAIN_HW[0]}, batch {batch}: {ms:.3f} ms a "
              f"step (CUDA events over steps {TRAIN_TIMED_FROM}-"
              f"{TRAIN_STEPS - 1}), peak device memory {peak:.1f} MiB "
              f"above the {base / 2**20:.1f} MiB held before, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; the host "
              f"generator {gen_ms:.1f} ms a batch; {card}", flush=True)
        if not all(math.isfinite(l) for l in losses):
            fail(f"train-width: {task}: a loss is not finite: {losses}")
        out[task] = dict(ms=ms, peak_mib=peak, first=losses[0],
                         last=losses[-1], batch=batch)
        del tr, model, batches
    return out


def retrain_phase(torch, dev, card):
    """Phase 20c: the port's weights tool, each file loaded back, the
    retrained stereo net held to phase 17's gate."""
    import shutil

    import numpy as np

    from dynamic_vins_tpu_torch.models import layers, pretrained
    from dynamic_vins_tpu_torch.models.stereo_net import StereoNet
    from dynamic_vins_tpu_torch.tools import train_shipped_weights as tool
    from dynamic_vins_tpu_torch.training import data, losses
    from dynamic_vins_tpu_torch.training.cli import _norm

    out_dir = REPO / "output" / "chip_smoke_weights"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    tool.main(["--tasks", "stereo", "--out-dir", str(out_dir)])
    stereo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tool.main(["--tasks", "solo,det3d,flow,reid", "--scale",
               str(RETRAIN_SCALE), "--out-dir", str(out_dir)])
    rest_s = time.perf_counter() - t0
    with open(out_dir / "MANIFEST.json") as f:
        man = json.load(f)
    if set(man) != set(tool.RECIPES):
        fail(f"retrain: the manifest holds {sorted(man)}")
    img = np.random.default_rng(SEED).uniform(0, 255, TRAIN_HW).astype(
        np.float32)
    intr = [460.0, 460.0, TRAIN_HW[1] / 2, TRAIN_HW[0] / 2]
    for task, entry in man.items():
        path = str(out_dir / entry["file"])
        net = pretrained.load_online(task, TRAIN_HW, intr, device=dev,
                                     params_path=path)
        if task in ("stereo", "flow"):
            net(img, img)
        elif task == "reid":
            net(np.repeat(img[..., None], 3, -1), np.array([[0, 0, 32, 64]]))
        else:
            net(img)
    # phase 17's stereo gate on its batch, and against the untrained net
    rng = np.random.default_rng(ACC_SEED)
    data.stereo_batch(rng, 2, ACC_HW, 32)
    left, right, disp, valid = (torch.from_numpy(a).to(dev) for a in
                                data.stereo_batch(rng, 2, ACC_HW, 32))
    epe = {}
    for name, path in (("retrained", str(out_dir / "stereo.npz")),
                       ("untrained", None)):
        net = pretrained.prepare(StereoNet(max_disp=32,
                                           gen=layers.seeded(0)), path,
                                 torch.float32, dev)
        with torch.no_grad():
            epe[name] = float(losses.stereo_loss(
                net(_norm(left), _norm(right)), disp, valid))
    print(f"retrain: stereo {man['stereo']['trained']['steps']} steps in "
          f"{stereo_s:.1f} s, the other four at scale {RETRAIN_SCALE} in "
          f"{rest_s:.1f} s, each file loaded back through load_online; "
          f"the retrained stereo net's smooth-L1 EPE {epe['retrained']:.4f}"
          f" px (gate < {ACC_STEREO_PX}), untrained {epe['untrained']:.4f}"
          f" px (gate < 0.5x); manifest {json.dumps(man)}; {card}",
          flush=True)
    if not (epe["retrained"] < ACC_STEREO_PX
            and epe["retrained"] < 0.5 * epe["untrained"]):
        fail(f"retrain: the retrained stereo net misses its gate: {epe}")
    return dict(stereo_s=stereo_s, rest_s=rest_s, **epe)


def shipped_gates_phase(torch, dev, card):
    """Phase 20d: SOLOv2's and FCOS3D's shipped weights against
    tests/test_shipped_weights.py's gates, with the port's losses."""
    import numpy as np

    from dynamic_vins_tpu_torch.models import pretrained
    from dynamic_vins_tpu_torch.training import cli
    from dynamic_vins_tpu_torch.training.trainer import to_device

    out = {}
    for task, (gate, ratio) in SHIPPED_GATES.items():
        model, loss_fn, gen = cli.build_task(
            task, ACC_HW, np.random.default_rng(ACC_SEED), 2, dev)
        batch = to_device(gen(), dev)
        with torch.no_grad():
            untrained = float(loss_fn(model, batch)[0])
            pretrained.prepare(model, pretrained.weights_path(task),
                               torch.float32, dev)
            trained = float(loss_fn(model, batch)[0])
        print(f"shipped-gates: {task}: loss {trained:.4f} (gate < {gate}), "
              f"untrained {untrained:.4f} ({trained / untrained:.3f}x, "
              f"gate < {ratio}x); {card}", flush=True)
        if not (trained < gate and trained < ratio * untrained):
            fail(f"shipped-gates: {task}: {trained} against {untrained}")
        out[task] = dict(loss=trained, untrained=untrained)
    return out


def precompute_phase(torch, card):
    """Phase 20e: the port's precompute tool over phase 12's KITTI tree."""
    import shutil

    import numpy as np

    from dynamic_vins_tpu_torch.io import perception
    from dynamic_vins_tpu_torch.tools import precompute

    tree = REPO / "output" / "chip_smoke_cli" / "kitti"
    left, right = tree / "image_02" / "0000", tree / "image_03" / "0000"
    out = REPO / "output" / "chip_smoke_precompute"
    ms = []
    for run in range(2):
        shutil.rmtree(out, ignore_errors=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            precompute.main(["--left", str(left), "--right", str(right),
                             "--out", str(out), "--tasks",
                             "seg,det3d,disp,flow", "--max-frames",
                             str(PRE_FRAMES)])
        print(buf.getvalue(), end="", flush=True)
        # the tool's own frame loop (the nets' loading excluded)
        ms.append(float(re.search(r"\(([0-9.]+) ms/frame\)",
                                  buf.getvalue()).group(1)))
    dets = boxes = 0
    for i in range(PRE_FRAMES):
        name = f"{i:06d}"
        seg = perception.read_solo_seg_pt(str(out / "seg"), name, 0.0)
        txt = out / "det3d" / f"{name}.txt"
        disp = perception.read_disparity_png(str(out / "disp" /
                                                 f"{name}.png"))
        if seg is None or not txt.exists() or disp is None:
            fail(f"precompute: frame {name}: an artifact is missing")
        dets += len(seg.scores)
        boxes += len(perception.read_fcos3d_txt(str(txt), 0.0))
        if disp.shape != (480, 752) or not np.isfinite(disp).all():
            fail(f"precompute: frame {name}: disparity {disp.shape}")
        flow_path = out / "flow" / f"{name}.npy"
        if i > 0:
            flow = np.load(flow_path)
            if flow.shape != (480, 752, 2) or not np.isfinite(flow).all():
                fail(f"precompute: frame {name}: flow {flow.shape}")
        elif flow_path.exists():
            fail("precompute: a flow field for the first frame")
    print(f"precompute: {PRE_FRAMES} frames of phase 12's KITTI tree "
          f"(752x480), tasks seg, det3d, disp, flow on the card: "
          f"{ms[0]:.1f} ms a frame (first run: cuDNN's plans included), "
          f"{ms[1]:.1f} ms a frame (second run; the tool's frame loop, "
          f"the nets' loading excluded); read "
          f"back: {dets} detections, {boxes} boxes, {PRE_FRAMES} "
          f"disparities, {PRE_FRAMES - 1} flow fields; {card}", flush=True)
    return dict(ms_first=ms[0], ms=ms[1])


def weights_digest():
    """sha256 of every file under dynamic_vins_tpu/weights/."""
    import hashlib

    wdir = REPO / "dynamic_vins_tpu" / "weights"
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(wdir.iterdir())}


def training_phase(torch, dev, card):
    """Phase 20 (see the module docstring)."""
    import threading

    # the steps are launch-bound: other threads alive share the host
    names = [t.name for t in threading.enumerate()]
    print(f"training: threads alive {names}", flush=True)
    before = weights_digest()
    out = dict(gates=training_gates_phase(torch, dev, card),
               width=training_width_phase(torch, dev, card),
               retrain=retrain_phase(torch, dev, card),
               shipped=shipped_gates_phase(torch, dev, card),
               precompute=precompute_phase(torch, card))
    if weights_digest() != before:
        fail("training: dynamic_vins_tpu/weights/ changed")
    return out


def stamp(name):
    """One line of the script's clock: where a phase ended."""
    print(f"clock: {name} ended {time.perf_counter() - START:.1f} s after "
          f"the start", flush=True)


def start_cpu_probe():
    """Phase 21a's float64 baseline: the port's accuracy probe on the
    CPU (`--platform cpu --x64 --seeds 1`) in a process of its own at
    nice 19, started at phase 20 (no main-path phase runs beside it) and
    read at phase 21a. A thread collects its output and the moment it
    ended; it is killed if the script ends first."""
    import atexit
    import os
    import threading

    env = dict(os.environ, OMP_NUM_THREADS=str(PROBE_CPU_THREADS))
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamic_vins_tpu_torch.tools.accuracy_probe",
         "--platform", "cpu", "--x64", "--seeds", "1"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    os.setpriority(os.PRIO_PROCESS, proc.pid, 19)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    done = {}

    def collect():
        done["out"], done["err"] = proc.communicate()
        done["s"] = time.perf_counter() - t_start

    waiter = threading.Thread(target=collect, daemon=True)
    waiter.start()
    return proc, waiter, done


def probe_phase(torch, dev, card, probe):
    """Phase 21a: the accuracy probe on the card, seeds 0-2, float32 and
    float64, against the CPU's float64 seed 0."""
    from dynamic_vins_tpu_torch.tools import accuracy_probe

    res = {}
    for name, dtype in (("float32", torch.float32),
                        ("float64", torch.float64)):
        t0 = time.perf_counter()
        res[name] = accuracy_probe.run_protocol([0, 1, 2], dtype=dtype,
                                                device=dev)
        print(f"probe: card {name}: aligned ATE median "
              f"{res[name][0]:.6f} m, unaligned {res[name][1]:.6f} m, "
              f"per seed {res[name][2]} ({time.perf_counter() - t0:.1f} s, "
              f"42 frames, window 11, pipelined); {card}", flush=True)
    proc, waiter, done = probe
    t0 = time.perf_counter()
    waiter.join(timeout=PROBE_CPU_TIMEOUT_S)
    if waiter.is_alive():
        fail(f"probe: the CPU probe did not end within "
             f"{PROBE_CPU_TIMEOUT_S} s of phase 21a")
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"probe: the CPU probe exited {proc.returncode}: "
             f"{done['err'][-2000:]}")
    cpu = json.loads(done["out"].strip().splitlines()[-1])
    f32, f64 = res["float32"], res["float64"]
    gap = abs(f64[2][0] - cpu["ate_aligned"])
    print(f"probe: CPU float64 (port, subprocess at nice 19, "
          f"{PROBE_CPU_THREADS} threads, started at phase 20, ended "
          f"{done['s']:.1f} s after its start; phase 21a waited "
          f"{waited:.1f} s for it): "
          f"{json.dumps(cpu)}; card float64 seed 0 {f64[2][0]:.4f} m, "
          f"|card - CPU| {gap:.2e} m (gate {PROBE_ATOL_M} m, the CPU's "
          f"line rounds to 4 places); float32 - float64 on the card: "
          f"aligned {f32[0] - f64[0]:+.6f} m, unaligned "
          f"{f32[1] - f64[1]:+.6f} m, per seed "
          f"{[round(a - b, 4) for a, b in zip(f32[2], f64[2])]}", flush=True)
    if not gap <= PROBE_ATOL_M:
        fail(f"probe: the card's float64 seed 0 lies {gap} m from the CPU's")
    import numpy as np

    if not np.isfinite([*f32[:2], *f64[:2], *f32[2], *f64[2]]).all():
        fail("probe: a non-finite ATE")
    return dict(card=res, cpu=cpu)


def dynamic_bench_phase(card):
    """Phase 21b: `tools.dynamic_bench` with its defaults on the card."""
    import numpy as np

    from dynamic_vins_tpu_torch.tools import dynamic_bench

    t0 = time.perf_counter()
    res = dynamic_bench.run()
    d = res["detail"]
    nums = [res["value"], d["mean_ms"], d["p90_ms"], d["ego_ate_m"]] + [
        v for e in d["objects_err"].values() for v in e.values()]
    print(f"dynamic-bench ({time.perf_counter() - t0:.1f} s; {card}):",
          json.dumps(res), flush=True)
    if not d["objects_err"] or not np.isfinite(
            np.array(nums, dtype=float)).all():
        fail(f"dynamic-bench: a missing or non-finite number: {res}")
    return res


def scaling_phase(card):
    """Phase 21c: `tools.singlechip_scaling --fast` on the card."""
    from dynamic_vins_tpu_torch.tools import singlechip_scaling

    t0 = time.perf_counter()
    res = singlechip_scaling.run(fast=True)
    print(f"scaling ({time.perf_counter() - t0:.1f} s; {card}):",
          json.dumps(res), flush=True)
    for r in res["obs_sweep"]:
        print(f"scaling: obs rows {r['obs_rows']:6d}: {r['ms_10iter']:8.2f} "
              f"ms / 10 iterations, final cost {r['final_cost']:.6g}",
              flush=True)
    for r in res["lm_sweep"]:
        print(f"scaling: landmark slots {r['lm_slots']:5d}: "
              f"{r['ms_10iter']:8.2f} ms / 10 iterations", flush=True)
    for r in res["batched_windows"]:
        print(f"scaling: {r['windows']} windows ({r['how']}): "
              f"{r['ms_10iter']:8.2f} ms, {r['windows_per_s']} windows/s; "
              f"state vs B = 1 {r['max_state_diff']:.3e}, vs the unbatched "
              f"solve {r['max_diff_unbatched']:.3e}, vs the float64 solve "
              f"{r['max_diff_f64']:.3e} (gate {BATCH_F32_ATOL})", flush=True)
    print(f"scaling: float32 rounding: the unbatched float32 solve lies "
          f"{res['f32_unbatched_vs_f64']:.3e} from the float64 solve of the "
          f"same inputs", flush=True)
    chk = res["batched_check_f64"]
    print(f"scaling: {chk['windows']} windows ({chk['how']}): state vs "
          f"B = 1 {chk['max_state_diff']:.3e}, vs the unbatched solve "
          f"{chk['max_diff_unbatched']:.3e} (gate {BATCH_ATOL})", flush=True)
    if not max(chk["max_state_diff"], chk["max_diff_unbatched"]) \
            <= BATCH_ATOL:
        fail(f"scaling: a batched window's float64 state lies "
             f"{chk['max_state_diff']} from the B = 1 solve's and "
             f"{chk['max_diff_unbatched']} from the unbatched one's (gate "
             f"{BATCH_ATOL})")
    for r in res["batched_windows"]:
        worst = max(r["max_state_diff"], r["max_diff_unbatched"],
                    r["max_diff_f64"])
        if not worst <= BATCH_F32_ATOL:
            fail(f"scaling: {r['windows']} float32 windows lie {worst} "
                 f"from B = 1, the unbatched or the float64 solve (gate "
                 f"{BATCH_F32_ATOL})")
    return res


def _leaf_err(torch, a, b):
    """Largest |a - b| over matching leaves, relative to b's scale."""
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    if len(la) != len(lb):
        return float("inf")
    err = 0.0
    for x, y in zip(la, lb):
        if x.shape != y.shape:
            return float("inf")
        x, y = x.double(), y.double()
        err = max(err, float((x - y).abs().max()
                             / y.abs().max().clamp_min(1e-12)))
    return err


def engines_phase(torch, dev, card, imgs, rig):
    """Phase 21d: `tools.build_engines` for the five stages at 480x752
    into build/engines; each engine against its live function on phase
    16's inputs."""
    from dynamic_vins_tpu_torch.tools import build_engines

    left, right, nxt, boxes = _net_inputs(imgs)
    hw = left.shape
    intr = [float(v) for v in rig.intr[:4]]
    out_dir = REPO / "build" / "engines"
    t = lambda a: torch.from_numpy(a.astype("float32")).to(dev)
    res = {}
    for task in build_engines.TASKS:
        t0 = time.perf_counter()
        path = build_engines.export_stage(task, hw, str(out_dir), intr,
                                          device=dev)
        export_s = time.perf_counter() - t0
        fn, params, _ = build_engines.stage_fn(task, hw, intr, device=dev)
        engine = build_engines.load_engine(path)
        if task == "reid":
            from dynamic_vins_tpu_torch.models import pretrained

            inputs = [t(pretrained.load_online("reid", None, device=dev)
                        .crops(left, boxes))]
        else:
            inputs = {"solo": [t(left)], "det3d": [t(left)],
                      "stereo": [t(left), t(right)],
                      "flow": [t(left), t(nxt)]}[task]
        with torch.no_grad():
            live = fn(params, *inputs)
            got = engine(params, *inputs)
            err = _leaf_err(torch, got, live)
            ms = _timed(torch, lambda: engine(params, *inputs), 10)
            live_ms = _timed(torch, lambda: fn(params, *inputs), 10)
        size = Path(path).stat().st_size
        print(f"engines: {task}: {size} bytes, exported in {export_s:.1f} "
              f"s; engine {ms:.3f} ms a call, live function {live_ms:.3f} "
              f"ms (CUDA events, 10 calls after 5); engine vs live "
              f"{err:.3e} of scale (gate {ENGINE_RTOL}); {card}",
              flush=True)
        if not err <= ENGINE_RTOL:
            fail(f"engines: {task}: the engine differs from its live "
                 f"function by {err} of scale")
        res[task] = dict(bytes=size, ms=ms, live_ms=live_ms, err=err)
    return res


def record_replay_phase(torch, dev, card, seq, imgs, imus):
    """Phase 21e: the RAW slice records its features; a fresh float32
    estimator replays them."""
    import numpy as np

    from dynamic_vins_tpu_torch.estimator.estimator import Estimator
    from dynamic_vins_tpu_torch.io import feature_serialization as fs
    from dynamic_vins_tpu_torch.sim import synthetic as sim

    path = REPO / "output" / "chip_smoke_features.jsonl"
    # the card's index_add_ sums with atomics in a run-dependent order,
    # and the float32 LM carries that to centimetres over 30 frames (two
    # replays of one file part by 1.4e-2 m, PERF.md): both runs sum in a
    # fixed order here, so the gate sees what record/replay changes
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        live = run_slice(torch, dev, seq, imgs, imus, "record",
                         record=str(path))
        est = Estimator(live["cfg"], live["p_bc"], live["q_bc"],
                        noise=live["noise"], device=dev)
        est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                             sim.state_at(seq.frame_times[0])[2].numpy())
        t0 = time.perf_counter()
        replayed = [est.process_frame(f, i)
                    for f, i in fs.replay(str(path))]
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = list(zip(live["est_outs"], replayed))
    if len(replayed) != FRAMES or any((a is None) != (b is None)
                                      for a, b in pairs):
        fail(f"record: {len(replayed)} replayed frames, or outputs on "
             f"other frames than the live run's")
    both = [(a, b) for a, b in pairs if a is not None]
    if any(a.timestamp != b.timestamp for a, b in both):
        fail("record: replayed timestamps differ from the live run's")
    diff = max(float(np.abs(a.p - b.p).max()) for a, b in both)
    exact = all(np.array_equal(a.p, b.p) and np.array_equal(a.q, b.q)
                for a, b in both)
    print(f"record: {FRAMES} frames recorded ({path.stat().st_size} "
          f"bytes; deterministic sums in both runs), replayed by a fresh "
          f"{est.dtype} estimator in "
          f"{replay_s:.2f} s: {len(both)} outputs, largest position "
          f"difference from the live run {diff:.3e} m (gate "
          f"{REPLAY_ATOL_M} m), bit-equal {exact}; kernel launches of the "
          f"recording run {json.dumps(live['launches'])}; {card}",
          flush=True)
    if not diff <= REPLAY_ATOL_M:
        fail(f"record: the replay lies {diff} m from the live run")
    return dict(launches=live["launches"], diff=diff, exact=exact)


def loader_phase(card):
    """Phase 21f: `io.native_loader.PrefetchLoader` over phase 12's EuRoC
    PNG tree against sequential decoding."""
    import numpy as np

    from dynamic_vins_tpu_torch.io import image_io, native_loader

    mav = REPO / "output" / "chip_smoke_cli" / "euroc" / "mav0"
    paths = sorted(str(p) for c in ("cam0", "cam1")
                   for p in (mav / c / "data").glob("*.png"))
    if len(paths) != 2 * FRAMES:
        fail(f"loader: {len(paths)} PNGs under {mav}, not {2 * FRAMES}")
    t0 = time.perf_counter()
    seq_imgs = [native_loader.decode_image(p) for p in paths]
    seq_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    t0 = time.perf_counter()
    with native_loader.PrefetchLoader(paths, workers=LOADER_WORKERS,
                                      capacity=8) as loader:
        got = list(loader)
    pre_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    bad = [i for i, (k, img) in enumerate(got)
           if k != i or not np.array_equal(img, seq_imgs[i])
           or not np.array_equal(img, image_io.imread(paths[i], "grey"))]
    print(f"loader: {len(paths)} PNGs 752x480 grey, PrefetchLoader "
          f"({LOADER_WORKERS} workers, capacity 8) {pre_ms:.3f} ms a frame "
          f"against sequential decode_image {seq_ms:.3f} ms; frames equal "
          f"to image_io's decode: {len(got) - len(bad)}/{len(paths)}; "
          f"{card}", flush=True)
    if len(got) != len(paths) or bad:
        fail(f"loader: {len(got)} frames, {len(bad)} differ or out of "
             f"order")
    return dict(ms=pre_ms, seq_ms=seq_ms)


def _calib_views():
    """tests/test_calibration.py's synthetic views (7x5 board, 8 views),
    made with the port's camera and Lie functions."""
    import numpy as np
    import torch

    from dynamic_vins_tpu_torch.geometry import camera as cam
    from dynamic_vins_tpu_torch.geometry import lie

    intr = cam.PinholeIntrinsics.make(480.0, 470.0, 320.0, 240.0, 0.05,
                                      -0.02, 0.001, -0.0005,
                                      dtype=torch.float64)
    gx, gy = np.meshgrid(np.arange(7) * 0.03, np.arange(5) * 0.03)
    obj = np.stack([gx.ravel(), gy.ravel()], axis=1)
    obj -= obj.mean(axis=0)
    rng = np.random.default_rng(0)
    views = []
    for _ in range(8):
        rv = rng.normal(scale=0.25, size=3)
        rv[2] = rng.normal(scale=0.6)
        tv = np.array([rng.normal(scale=0.05), rng.normal(scale=0.05),
                       0.5 + 0.3 * rng.random()])
        q = lie.so3_exp_quat(torch.from_numpy(rv))
        p3 = torch.from_numpy(np.concatenate(
            [obj, np.zeros((len(obj), 1))], axis=1))
        pc = lie.quat_rotate(q[None, :], p3) + torch.from_numpy(tv)
        views.append((obj.copy(), cam.project(intr, pc).numpy()))
    return views


def camera_phase(torch, dev, card):
    """Phase 21g: the three non-pinhole models' roundtrips over a 752x480
    pixel grid on the card, and planar calibration card against CPU."""
    import numpy as np

    from dynamic_vins_tpu_torch.geometry import calibration as cal
    from dynamic_vins_tpu_torch.geometry import camera as cam

    poly = [-250.0, 0.0, 1.2e-3, -2.0e-7, 1.0e-10]
    inv = cam.scaramuzza_fit_inverse(poly, max_rho=450.0)
    models = dict(
        equidistant=(cam.EquidistantIntrinsics.make(
            380.8, 380.3, 376.0, 240.0, k2=-0.01, k3=0.02, k4=-0.02,
            k5=0.005, dtype=torch.float64),
            lambda i, x: cam.equidistant_lift(i, x, num_iters=12),
            cam.equidistant_project),
        cata=(cam.CataIntrinsics.make(
            0.9, 360.0, 362.0, 376.0, 240.0, k1=-0.1, k2=0.02, p1=1e-4,
            p2=-2e-4, dtype=torch.float64),
            lambda i, x: cam.cata_lift(i, x, num_iters=12),
            cam.cata_project),
        scaramuzza=(cam.ScaramuzzaIntrinsics.make(
            poly, inv, 376.0, 240.0, c=1.001, d=1e-4, e=-2e-4,
            dtype=torch.float64), cam.scaramuzza_lift,
            cam.scaramuzza_project))
    v, u = torch.meshgrid(torch.arange(480, dtype=torch.float64),
                          torch.arange(752, dtype=torch.float64),
                          indexing="ij")
    grid = torch.stack([u, v], -1).reshape(-1, 2)
    errs = {}
    for name, (intr, lift, project) in models.items():
        for dtype, gate in ((torch.float64, CAM_F64_PX),
                            (torch.float32, CAM_F32_PX)):
            for where in (dev, "cpu"):
                i = intr.to(device=where, dtype=dtype)
                x = grid.to(device=where, dtype=dtype)
                back = project(i, lift(i, x) * 3.0)
                err = float((back - x).abs().max())
                if where == dev:
                    torch.cuda.synchronize()
                errs[(name, str(dtype), str(where))] = err
            key = (name, str(dtype))
            card_err, cpu_err = errs[key + (str(dev),)], errs[key + ("cpu",)]
            print(f"cameras: {name} {str(dtype)[6:]}: pixel -> ray -> pixel "
                  f"over the 752x480 grid, max error card {card_err:.3e} "
                  f"px, CPU {cpu_err:.3e} px (gate {gate} px)", flush=True)
            if not card_err <= gate:
                fail(f"cameras: {name} {dtype}: roundtrip error {card_err} "
                     f"px on the card")
    views = _calib_views()
    t0 = time.perf_counter()
    on_card = cal.calibrate_planar(views, device=dev)
    card_s = time.perf_counter() - t0
    on_cpu = cal.calibrate_planar(views, device="cpu")
    diff = max(max(abs(getattr(on_card, k) - getattr(on_cpu, k))
                   for k in ("fx", "fy", "cx", "cy", "rms")),
               *(float(np.abs(getattr(on_card, k) - getattr(on_cpu, k))
                       .max()) for k in ("dist", "rvecs", "tvecs")))
    print(f"cameras: calibrate_planar on the card ({card_s:.2f} s, float64, "
          f"8 views): fx {on_card.fx:.6f} fy {on_card.fy:.6f} cx "
          f"{on_card.cx:.6f} cy {on_card.cy:.6f} rms {on_card.rms:.3e} px; "
          f"largest difference from the CPU's {diff:.3e} (gate {CALIB_ATOL});"
          f" {card}", flush=True)
    if not diff <= CALIB_ATOL:
        fail(f"cameras: calibrate_planar on the card lies {diff} from the "
             f"CPU's")
    return dict(roundtrip=errs, calib_diff=diff)


def bench_tools_phase(torch, dev, card, seq, imgs, imus, probe):
    """Phase 21 (see the module docstring)."""
    out = {}
    # 21d first: its times are CUDA events, and it leaves the CPU probe
    # (started at phase 20) time to end before 21a reads it
    for name, part in (
            ("engines", lambda: engines_phase(torch, dev, card, imgs,
                                              seq.rig)),
            ("probe", lambda: probe_phase(torch, dev, card, probe)),
            ("dynamic", lambda: dynamic_bench_phase(card)),
            ("scaling", lambda: scaling_phase(card)),
            ("record", lambda: record_replay_phase(torch, dev, card, seq,
                                                   imgs, imus)),
            ("loader", lambda: loader_phase(card)),
            ("cameras", lambda: camera_phase(torch, dev, card))):
        out[name] = part()
        stamp(f"phase 21 {name}")
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    card = device_phase(torch)
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda")
    build_phase()
    stamp("build")
    t0 = time.perf_counter()
    seq, imgs, imus = make_scene(torch, dev)
    dframes, objs = make_dynamic(torch, dev, seq)
    print(f"rendered {FRAMES} stereo frames, and again with "
          f"{N_OBJECTS} objects ({[len(d.seg.masks) for d in dframes]} "
          f"masks a frame), in {time.perf_counter() - t0:.1f} s", flush=True)
    timed = dict(zip(("lk_level", "lk_track", "lk_track_r8"),
                     kernel_phase(torch, dev, imgs, dframes)))
    stamp("render, phase 3")
    seqr = run_slice(torch, dev, seq, imgs, imus, "slice")
    print("slice: megastep eager vs replay (ms, float32, CUDA events):",
          json.dumps(step_times(torch, seqr.pop("graph"))), flush=True)
    graph_check_phase(torch, dev, seq)
    stamp("phase 5")
    pipe = run_slice(torch, dev, seq, imgs, imus, "pipelined",
                     pipelined=True)
    stamp("phase 6")
    p_pipe = pipe["p"]
    # float32 on the card: no gate (see the module docstring)
    print(f"pipelined: max |p - p_sequential| "
          f"{float(abs(p_pipe - seqr['p']).max()):.3e} m (float32)",
          flush=True)
    multi = run_slice(torch, dev, seq, imgs, imus, "multi-dispatch",
                      frames=MULTI_FRAMES, use_megastep=False)
    stamp("phase 7")
    import numpy as np

    mask = np.zeros((seq.rig.height, seq.rig.width), bool)
    mask[120:360, 250:500] = True    # a fixed "dynamic" rectangle
    naive = run_slice(torch, dev, seq, imgs, imus, "naive",
                      frames=NAIVE_FRAMES, dynamic_mask=mask)
    stamp("phase 8")
    dyn = run_dynamic(torch, dev, seq, dframes, objs, imus)
    print("dynamic: object solve eager vs replay (ms, float32, CUDA "
          "events):", json.dumps(solve_times(torch, dyn["solve"])),
          flush=True)
    naive_pipe = run_slice(torch, dev, seq, imgs, imus, "naive-pipelined",
                           frames=NAIVE_FRAMES, pipelined=True,
                           dynamic_mask=mask)
    stamp("phases 9-10")
    dyn_pipe = run_dynamic(torch, dev, seq, dframes, objs, imus,
                           pipelined=True)
    print(f"dynamic-pipelined: steady ms/frame {dyn_pipe['steady_ms']:.2f}"
          f" against the sequential DYNAMIC phase's "
          f"{dyn['steady_ms']:.2f}", flush=True)
    stamp("phase 11")
    cli = cli_phase(torch, seq, imgs, dframes, objs)
    stamp("phase 12")
    mono = mono_phase(torch, dev, seq, imgs, imus)
    stamp("phase 13a")
    mono_reference_phase(torch, dev)
    stamp("phase 13b")
    resume_phase(torch, dev, seq)
    stamp("phase 14")
    lines = linepoint_phase(torch, dev, seq, imgs, imus)
    stamp("phase 15")
    nets_phase(torch, dev, card, imgs, seq.rig)
    stamp("phase 16")
    accuracy_phase(torch, dev)
    stamp("phase 17")
    online = online_phase(torch, dev, seq, dframes, imus)
    stamp("phase 18")
    loop = loop_phase(torch, dev, seq)
    stamp("phase 19")
    probe = start_cpu_probe()
    training_phase(torch, dev, card)
    stamp("phase 20")
    tools = bench_tools_phase(torch, dev, card, seq, imgs, imus, probe)
    # launches of every main-path phase (4, 6-13, 15, 18, 19, 21e), each
    # counted from 0
    launches = dict(lk_level=0, lk_track=0, lk_track_r8=0)
    for r in (seqr, pipe, multi, naive, naive_pipe, dict(launches=mono),
              lines, *loop["runs"], tools["record"]):
        launches["lk_level"] += r["launches"]["lk_level"]
        launches["lk_track"] += r["launches"]["lk_track"]
    for r in (dyn["launches"], dyn_pipe["launches"], cli,
              online["launches"]):
        launches["lk_level"] += r["lk_level"]
        launches["lk_track"] += r["lk_track_r10"]
        launches["lk_track_r8"] += r["lk_track_r8"]
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda",
        source="dynamic_vins_tpu_torch/csrc/lk_level.cu",
        replaces=LK_TPU_KERNEL, launches=launches[name],
        max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None)
        for name, k in timed.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
