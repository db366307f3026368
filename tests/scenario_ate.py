#!/usr/bin/env python3
"""Unaligned ATE of the chip_smoke.py slice scenario (752x480 rendered
stereo + IMU, seed 0, RAW System with VioConfig defaults) through the
port or through the JAX package, for any blob size, landmark count and
camera rate (defaults: chip_smoke's).

    python tests/scenario_ate.py --impl torch --sigma 3.2 --dtype f32 --lk plain
    python tests/scenario_ate.py --impl torch --device cuda --sigma 1.6
    python tests/scenario_ate.py --impl jax --sigma 1.6
    python tests/scenario_ate.py --impl both --sigma 1.6 --no-ransac-f
    python tests/scenario_ate.py --impl both --lk plain
    python tests/scenario_ate.py --lk-vs-truth --frame-hz 10
    python tests/scenario_ate.py --impl both --slam dynamic --no-ransac-f

Prints one line per frame (features, position error) and, last, the
ATE. The port runs on --device (default cpu) with its estimator in
--dtype and its LK in --lk; the JAX System runs on the CPU in float64
with its CPU LK (the Scharr/gather form), or, with --lk plain or cuda,
the kernel's semantics: the Pallas level in interpret mode with the
seeded level-0 back-check. Both estimators take their default path,
the steady state as one megastep a frame, or with --multi-dispatch the
multi-dispatch path (`use_megastep = False`). `--slam dynamic` runs the
DYNAMIC System on chip_smoke's dynamic scene (the same scene with 3
moving textured boxes, their masks, disparity and 3D boxes; each side
renders it with its own simulator) and also prints, per instance, the
distance of its final estimate to the nearest object's truth.
RANSAC-F is each side's own (OpenCV on the JAX side, where installed),
or off on both with --no-ransac-f. `--impl both` runs the two on the
same frames and prints, per frame, where they part: the tracked slot
sets, the largest point difference over slots valid on both sides, and
the distance between the two position estimates.
`--lk-vs-truth` instead tracks the corners of frame 0 into frame 1
(temporal) and into the right image (stereo) with the port's two LK
forms, the kernel's semantics ("plain") and the Scharr/gather form
("xla"), and prints how far the tracks it accepts land from the
ground-truth projection of the landmark each corner sits on.
The torch path imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _frame(tracker, out):
    """What one frame leaves: tracked slots, their points, the position."""
    return dict(valid=tracker.valid.copy(),
                pts=np.asarray(tracker.pts, np.float64),
                p=np.asarray(out.p, np.float64))


def _report(gt, out, failed, what):
    for k, f in enumerate(out):
        print(f"frame {k:2d} features {int(f['valid'].sum()):3d} position "
              f"error {np.linalg.norm(f['p'] - gt[k]):.4f} m", flush=True)
    est = np.stack([f["p"] for f in out])
    ate = float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))
    print(f"{what}: ATE {ate:.4f} m, failed {failed}", flush=True)


def _compare(out_t, out_j):
    """Per frame: slots valid on one side only, the largest point
    difference over slots valid on both, and |p_torch - p_jax|."""
    for k, (t, j) in enumerate(zip(out_t, out_j)):
        both = t["valid"] & j["valid"]
        dpts = float(np.abs(t["pts"][both] - j["pts"][both]).max()) \
            if both.any() else 0.0
        print(f"frame {k:2d} slots torch-only "
              f"{int((t['valid'] & ~j['valid']).sum()):3d} jax-only "
              f"{int((j['valid'] & ~t['valid']).sum()):3d} max |pts diff| "
              f"{dpts:.3e} px |p_torch - p_jax| "
              f"{np.linalg.norm(t['p'] - j['p']):.3e} m", flush=True)


def _instances(states, objs):
    """Per instance: distance of its final estimate to the nearest
    object's last true position."""
    for tid, s in sorted(states.items()):
        err = min(np.linalg.norm(np.asarray(o.gt_p[-1]) - s["p"])
                  for o in objs)
        print(f"instance {tid}: {err:.4f} m from the nearest object, "
              f"static {s['is_static']}", flush=True)


def _dyn_kw(df):
    return dict(seg=df.seg, boxes3d=df.boxes3d, disparity=df.disparity)


def run_torch(args):
    import torch

    from dynamic_vins_tpu_torch.frontend import lk
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.system import FrameInput, System
    from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig

    dev = torch.device(args.device)
    seq, imgs, imus = chip_smoke.make_scene(torch, dev, sigma=args.sigma,
                                            landmarks=args.landmarks,
                                            frame_hz=args.frame_hz)
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    cfg = chip_smoke.slice_config(seq.rig, VioConfig())
    dyn = args.slam == "dynamic"
    if dyn:
        cfg.slam = SlamMode.DYNAMIC
        dframes, objs = chip_smoke.make_dynamic(torch, dev, seq,
                                                sigma=args.sigma)
        imgs = [(d.img_left, d.img_right) for d in dframes]
    system = System(cfg, output_prefix=args.out + "_torch", device=dev,
                    dtype=dtype)
    system.estimator.cfg.use_megastep = not args.multi_dispatch
    tc = system.tracker.cfg
    tc.use_ransac_f = not args.no_ransac_f
    system.tracker._tracker = lk.make_tracker(
        tc.levels, tc.radius, tc.iters, tc.fb_thresh, tc.border,
        backend=args.lk, device=dev)
    system.estimator.set_initial_pose(
        seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
        sim.state_at(seq.frame_times[0])[2].numpy())
    out = []
    for k in range(chip_smoke.FRAMES):
        o = system.process(FrameInput(
            float(seq.frame_times[k]), imgs[k][0], imgs[k][1], imu=imus[k],
            **(_dyn_kw(dframes[k]) if dyn else {})))
        out.append(_frame(system.tracker, o))
    if dyn:
        _instances(system.estimator.get_instance_states(), objs)
    system.close()
    return seq.gt_p.numpy(), out, system.estimator.failed


def _use_pallas_interpret_lk():
    """Make the JAX tracker track with the Pallas LK level in interpret
    mode and the seeded level-0 back-check (the port's kernel
    semantics) instead of its CPU Scharr/gather form."""
    import jax

    from dynamic_vins_tpu.frontend import lk, pyramid
    from dynamic_vins_tpu.ops import lk_pallas

    def make_tracker(levels, radius, iters, fb_thresh, border, **_):
        level = lambda a, b, p, g: lk_pallas.lk_level(
            a, b, p, g, radius=radius, iters=iters, interpret=True)
        return jax.jit(lambda img0, img1, pts, valid: lk.track(
            pyramid.build_pyramid(img0, levels),
            pyramid.build_pyramid(img1, levels), pts, valid, radius=radius,
            iters=iters, fb_thresh=fb_thresh, border=border,
            level_fn=level, fb_levels=1))

    lk.make_tracker = make_tracker


def run_jax(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from dynamic_vins_tpu.geometry import lie
    from dynamic_vins_tpu.sim import dynamic_scene, frontend_sim, render
    from dynamic_vins_tpu.sim import synthetic as sim
    from dynamic_vins_tpu.system import FrameInput, System
    from dynamic_vins_tpu.utils.config import SlamMode, VioConfig

    n = chip_smoke.FRAMES
    seq = sim.generate_sequence(num_frames=n, frame_hz=args.frame_hz,
                                imu_hz=200.0, acc_noise=0.05,
                                gyr_noise=0.005,
                                num_landmarks=args.landmarks,
                                seed=chip_smoke.SEED)
    inten = render.make_intensities(args.landmarks, seed=chip_smoke.SEED)
    rig = seq.rig
    cfg = VioConfig()
    cfg.image_width, cfg.image_height = rig.width, rig.height
    cfg.intrinsics_left = [float(rig.intr.fx), float(rig.intr.fy),
                           float(rig.intr.cx), float(rig.intr.cy)]
    T0, T1 = np.eye(4), np.eye(4)
    T0[:3, :3] = np.asarray(lie.quat_to_matrix(rig.q_bc))
    T0[:3, 3] = np.asarray(rig.p_bc)
    pr, qr = rig.right_extrinsics()
    T1[:3, :3] = np.asarray(lie.quat_to_matrix(qr))
    T1[:3, 3] = np.asarray(pr)
    cfg.body_T_cam0 = T0.reshape(-1).tolist()
    cfg.body_T_cam1 = T1.reshape(-1).tolist()
    if args.lk in ("plain", "cuda"):
        _use_pallas_interpret_lk()
    dyn = args.slam == "dynamic"
    if dyn:
        cfg.slam = SlamMode.DYNAMIC
        draw_dyn = render.render_frame
        dynamic_scene.render.render_frame = \
            lambda *a, **k: draw_dyn(*a, sigma=args.sigma, **k)
        dframes, objs = dynamic_scene.make_dynamic_scene(
            seq, num_objects=chip_smoke.N_OBJECTS, seed=chip_smoke.SEED)
        dynamic_scene.render.render_frame = draw_dyn
    system = System(cfg, output_prefix=args.out + "_jax")
    system.estimator.cfg.use_megastep = not args.multi_dispatch
    system.tracker.cfg.use_ransac_f = not args.no_ransac_f
    system.estimator.set_initial_pose(
        np.asarray(seq.gt_p[0]), np.asarray(seq.gt_q[0]),
        np.asarray(sim.state_at(seq.frame_times[0])[2]))
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c, sigma=args.sigma),
        static_argnums=2)
    frames_imu = frontend_sim.make_frames(seq)
    out = []
    for k in range(n):
        if dyn:
            il, ir = dframes[k].img_left, dframes[k].img_right
        else:
            il = np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 0))
            ir = np.asarray(draw(seq.gt_p[k], seq.gt_q[k], 1))
        o = system.process(FrameInput(
            float(seq.frame_times[k]), il, ir, imu=frames_imu[k][1],
            **(_dyn_kw(dframes[k]) if dyn else {})))
        out.append(_frame(system.tracker, o))
    if dyn:
        _instances(system.estimator.get_instance_states(sync=True), objs)
    system.close()
    return np.asarray(seq.gt_p), out, system.estimator.failed


def lk_vs_truth(args):
    import torch

    from dynamic_vins_tpu_torch.frontend import corners, lk
    from dynamic_vins_tpu_torch.frontend.tracker import TrackerConfig
    from dynamic_vins_tpu_torch.sim import render
    from dynamic_vins_tpu_torch.sim import synthetic as sim

    seq = sim.generate_sequence(num_frames=2, frame_hz=args.frame_hz,
                                imu_hz=200.0, acc_noise=0.05,
                                gyr_noise=0.005,
                                num_landmarks=args.landmarks,
                                seed=chip_smoke.SEED)
    inten = render.make_intensities(args.landmarks, seed=chip_smoke.SEED)
    view = lambda k, c: (
        render.render_frame(seq.rig, seq.gt_p[k], seq.gt_q[k],
                            seq.landmarks, inten, cam=c,
                            sigma=args.sigma).float(),
        sim.observe(seq.rig, seq.gt_p[k], seq.gt_q[k], seq.landmarks,
                    cam=c))
    img0, (uv0, vis0, _) = view(0, 0)
    tc = TrackerConfig()
    pts, _, found = corners.detect(img0, max_corners=tc.max_cnt,
                                   min_dist=tc.min_dist, border=tc.border)
    for name, (img1, (uv1, vis1, _)) in (("temporal", view(1, 0)),
                                         ("stereo", view(0, 1))):
        # the landmark under each corner: the nearest projection seen in
        # both images, within 1.5 px
        d = torch.cdist(pts.double(), uv0) + 1e9 * (~(vis0 & vis1))[None]
        near = found & (d.min(dim=1).values < 1.5)
        truth = uv1[d.argmin(dim=1)].float()
        for backend in ("plain", "xla"):
            run = lk.make_tracker(tc.levels, tc.radius, tc.iters,
                                  tc.fb_thresh, tc.border, backend=backend)
            p1, ok = run(img0, img1, pts, found)
            err = (p1 - truth).norm(dim=1)[ok & near]
            print(f"{args.frame_hz} Hz {args.landmarks} landmarks {name} "
                  f"lk {backend}: {int(ok.sum())} tracks accepted, "
                  f"{err.numel()} on a landmark: error median "
                  f"{float(err.median()):.3f} px, {int((err > 3).sum())} "
                  f"above 3 px, max {float(err.max()):.1f} px", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("torch", "jax", "both"),
                    default="torch")
    ap.add_argument("--sigma", type=float, default=chip_smoke.BLOB_SIGMA_PX)
    ap.add_argument("--landmarks", type=int, default=chip_smoke.N_LANDMARKS)
    ap.add_argument("--frame-hz", type=float, default=chip_smoke.FRAME_HZ)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    ap.add_argument("--lk", choices=("auto", "xla", "plain", "cuda"),
                    default="auto")
    ap.add_argument("--no-ransac-f", action="store_true",
                    help="turn RANSAC-F off on both sides")
    ap.add_argument("--multi-dispatch", action="store_true",
                    help="both estimators on the multi-dispatch path")
    ap.add_argument("--slam", choices=("raw", "dynamic"), default="raw",
                    help="the RAW slice or the DYNAMIC one")
    ap.add_argument("--out", default="output/scenario_ate")
    ap.add_argument("--lk-vs-truth", action="store_true",
                    help="only compare the two LK forms with the ground "
                         "truth on frame 0")
    args = ap.parse_args()
    if args.lk_vs_truth:
        return lk_vs_truth(args)
    tag = (f"{args.slam} sigma {args.sigma} landmarks {args.landmarks} "
           f"{args.frame_hz} Hz ransac-f {not args.no_ransac_f} megastep "
           f"{not args.multi_dispatch}")
    runs = {}
    if args.impl in ("torch", "both"):
        runs["torch"] = run_torch(args)
        _report(*runs["torch"], f"torch {args.device} {args.dtype} lk "
                f"{args.lk} {tag}")
    if args.impl in ("jax", "both"):
        runs["jax"] = run_jax(args)
        _report(*runs["jax"], f"jax cpu f64 {tag}")
    if args.impl == "both":
        _compare(runs["torch"][1], runs["jax"][1])


if __name__ == "__main__":
    main()
