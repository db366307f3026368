"""CLI entry point: run the VIO system on a dataset, on the card.

Usage (the JAX package's CLI, argument for argument; mirrors `rosrun
dynamic_vins dynamic_vins <config.yaml> <seq>`, system/main.cpp:426):

  python -m dynamic_vins_tpu_torch.run --config cfg.yaml --seq 0003
  python -m dynamic_vins_tpu_torch.run --dataset synthetic --frames 40
  python -m dynamic_vins_tpu_torch.run --dataset euroc --root <MH_01_dir>
  python -m dynamic_vins_tpu_torch.run --dataset kitti --left <dir> \\
      --right <dir> --seg-dir <dir> --det3d-dir <dir> --disp-dir <dir> \\
      --slam dynamic

Runs on the CUDA card; `--cpu` runs on the CPU instead, and without it
a machine with no card raises. Images are decoded by `io/image_io` and
configs read by `VioConfig.from_yaml`'s own parser, so neither OpenCV
nor PyYAML is needed. `--loop-closure` adds ORB keyframes, loop edges
and the live pose-graph correction, and writes `<output>_ego_tum_loop.txt`
when a loop closed. `--devices > 1` raises naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from dynamic_vins_tpu_torch.io.evaluation import ate_rmse
from dynamic_vins_tpu_torch.system import FrameInput, System
from dynamic_vins_tpu_torch.utils.config import (DatasetType, SlamMode,
                                                 VioConfig)


def _system(cfg: VioConfig, args) -> System:
    """The System for a run: the run switches of the command line on
    top of the config, on the card unless --cpu."""
    cfg.use_loop_closure = getattr(args, "loop_closure", False)
    cfg.devices = getattr(args, "devices", 0)
    cfg.pipelined = getattr(args, "pipelined", False)
    return System(cfg, output_prefix=args.output,
                  device="cpu" if getattr(args, "cpu", False) else None)


def _print_ate(args, t_gt, p_gt):
    from dynamic_vins_tpu_torch.io.writers import read_tum

    t_est, p_est, _ = read_tum(args.output + "_ego_tum.txt")
    ate = ate_rmse(t_est, p_est, t_gt, p_gt, align=True)
    print(f"ATE RMSE vs ground truth: {ate:.4f} m")


def run_synthetic(args):
    import torch

    from dynamic_vins_tpu_torch.geometry import lie
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim

    cfg = VioConfig()
    cfg.window_size = args.window
    cfg.slam = SlamMode(args.slam)
    rig = sim.StereoRig.default(torch.float64)
    cfg.intrinsics_left = [float(v) for v in rig.intr[:4]]
    T0 = np.eye(4)
    T0[:3, :3] = lie.quat_to_matrix(rig.q_bc).numpy()
    T0[:3, 3] = rig.p_bc.numpy()
    T1 = np.eye(4)
    pr, qr = rig.right_extrinsics()
    T1[:3, :3] = lie.quat_to_matrix(qr).numpy()
    T1[:3, 3] = pr.numpy()
    cfg.body_T_cam0 = T0.reshape(-1).tolist()
    cfg.body_T_cam1 = T1.reshape(-1).tolist()

    seq = sim.generate_sequence(num_frames=args.frames, imu_hz=200.0,
                                acc_noise=0.02, gyr_noise=0.002,
                                num_landmarks=250, seed=args.seed)
    frames = frontend_sim.make_frames(seq, pixel_noise=0.5,
                                      seed=args.seed)
    sysm = _system(cfg, args)
    # synthetic mode: bypass the image frontend, feed simulated features
    sysm.estimator.set_initial_pose(
        seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
        sim.state_at(seq.frame_times[0])[2].numpy())
    t0 = time.perf_counter()
    outs = []
    for feats, imu in frames:
        with sysm.timer.stage("backend"):
            out = sysm.estimator.process_frame(feats, imu)
        if out is not None:           # pipelined: outputs lag dispatch
            outs.append(out)
            sysm.tum_writer.write(out.timestamp, out.p, out.q)
    for out in sysm.estimator.flush():
        outs.append(out)
        sysm.tum_writer.write(out.timestamp, out.p, out.q)
    wall = time.perf_counter() - t0
    summary = sysm.close()
    est_p = np.stack([o.p for o in outs])
    ate = ate_rmse(seq.frame_times.numpy(), est_p,
                   seq.frame_times.numpy(), seq.gt_p.numpy(), align=False)
    fps = len(outs) / wall
    print(f"frames={len(outs)} ATE={ate * 100:.2f}cm "
          f"fps={fps:.2f} stages={summary}")
    print(f"trajectory written to {args.output}_ego_tum.txt")
    return 0


def run_euroc(args):
    from dynamic_vins_tpu_torch.io.datasets import EurocDataset

    if args.config:
        cfg = VioConfig.from_yaml(args.config, args.seq)
    else:
        cfg = VioConfig()
        # EuRoC cam0 defaults (euroc.yaml / cam0_pinhole.yaml)
        cfg.intrinsics_left = [458.654, 457.296, 367.215, 248.375,
                               -0.28340811, 0.07395907, 0.00019359,
                               1.76187114e-05]
        cfg.intrinsics_right = [457.587, 456.134, 379.999, 255.238,
                                -0.28368365, 0.07451284, -0.00010473,
                                -3.55590700e-05]
        cfg.body_T_cam0 = [
            0.0148655429818, -0.999880929698, 0.00414029679422,
            -0.0216401454975,
            0.999557249008, 0.0149672133247, 0.025715529948,
            -0.064676986768,
            -0.0257744366974, 0.00375618835797, 0.999660727178,
            0.00981073058949,
            0.0, 0.0, 0.0, 1.0]
        cfg.body_T_cam1 = [
            0.0125552670891, -0.999755099723, 0.0182237714554,
            -0.0198435579556,
            0.999598781151, 0.0130119051815, 0.0251588363115,
            0.0453689425024,
            -0.0253898008918, 0.0179005838253, 0.999517347078,
            0.00786212447038,
            0.0, 0.0, 0.0, 1.0]
    ds = EurocDataset(args.root)
    imu = ds.imu()
    imu_t = np.array([s.t for s in imu])
    imu_acc = np.stack([s.acc for s in imu])
    imu_gyr = np.stack([s.gyr for s in imu])

    sysm = _system(cfg, args)
    prev_t = None
    count = 0
    t0 = time.perf_counter()
    for fr in ds.frames():
        if args.max_frames and count >= args.max_frames:
            break
        if prev_t is None:
            lo = np.searchsorted(imu_t, fr.t - 0.005)
            interval = (imu_acc[lo:lo + 2], imu_gyr[lo:lo + 2],
                        np.diff(imu_t[lo:lo + 2]))
        else:
            lo = np.searchsorted(imu_t, prev_t)
            hi = np.searchsorted(imu_t, fr.t)
            if hi - lo < 1:
                interval = None
            else:
                interval = (imu_acc[lo:hi + 1], imu_gyr[lo:hi + 1],
                            np.diff(imu_t[lo:hi + 1]))
        sysm.process(FrameInput(fr.t, fr.img_left, fr.img_right,
                                imu=interval))
        prev_t = fr.t
        count += 1
    wall = time.perf_counter() - t0
    summary = sysm.close()
    print(f"frames={count} fps={count / wall:.2f} stages={summary}")

    try:
        t_gt, p_gt, _ = ds.ground_truth()
        _print_ate(args, t_gt, p_gt)
    except Exception as e:
        print(f"(no ground truth evaluation: {e})")
    return 0


def run_viode(args, custom: bool = False):
    """VIODE (naive dynamic mode: mask-gated rejection, the reference's
    primary VIODE configuration, config/viode/viode.yaml).

    With `custom=True`: generic captured stereo+IMU directories in the
    same cam0/cam1/imu0 layout (the reference's ZED/MyntEye captures),
    raw mode, no segmentation expected."""
    from dynamic_vins_tpu_torch.io.datasets import (ViodeDataset,
                                                    viode_dynamic_mask)

    if args.config:
        cfg = VioConfig.from_yaml(args.config, args.seq)
    elif custom:
        cfg = VioConfig()
        cfg.dataset = DatasetType.CUSTOM
        cfg.slam = SlamMode(args.slam)
        if args.intrinsics:
            cfg.intrinsics_left = [float(v) for v
                                   in args.intrinsics.split(",")]
            cfg.intrinsics_right = cfg.intrinsics_left
    else:
        cfg = VioConfig()
        cfg.dataset = DatasetType.VIODE
        cfg.slam = SlamMode(args.slam if args.slam != "raw" else "naive")
        # VIODE calib (config/viode/{viode,cam0_pinhole}.yaml values)
        cfg.intrinsics_left = [376.0, 376.0, 376.0, 240.0]
        cfg.intrinsics_right = [376.0, 376.0, 376.0, 240.0]
        cfg.body_T_cam0 = [0, 0, 1, 0, 1, 0, 0, 0, 0, 1, 0, 0,
                           0, 0, 0, 1]
        cfg.body_T_cam1 = [0, 0, 1, 0, 1, 0, 0, 0.05, 0, 1, 0, 0,
                           0, 0, 0, 1]

    ds = ViodeDataset(args.root)
    imu = ds.imu()
    imu_t = np.array([s.t for s in imu])
    imu_acc = np.stack([s.acc for s in imu]) if imu else np.zeros((0, 3))
    imu_gyr = np.stack([s.gyr for s in imu]) if imu else np.zeros((0, 3))
    if not imu:
        cfg.use_imu = False

    sysm = _system(cfg, args)
    prev_t = None
    count = 0
    t0 = time.perf_counter()
    for fr in ds.frames():
        if args.max_frames and count >= args.max_frames:
            break
        interval = None
        if cfg.use_imu and prev_t is not None:
            lo = np.searchsorted(imu_t, prev_t)
            hi = np.searchsorted(imu_t, fr.t)
            if hi - lo >= 1:
                interval = (imu_acc[lo:hi + 1], imu_gyr[lo:hi + 1],
                            np.diff(imu_t[lo:hi + 1]))
        dyn_mask = viode_dynamic_mask(fr.seg_left) \
            if fr.seg_left is not None else None
        sysm.process(FrameInput(fr.t, fr.img_left, fr.img_right,
                                imu=interval, dynamic_mask=dyn_mask))
        prev_t = fr.t
        count += 1
    wall = time.perf_counter() - t0
    summary = sysm.close()
    print(f"frames={count} fps={count / max(wall, 1e-9):.2f} "
          f"stages={summary}")
    try:
        gt = ds.ground_truth()
        _print_ate(args, np.array([g[0] for g in gt]),
                   np.stack([g[1] for g in gt]))
    except Exception as e:
        print(f"(no ground truth evaluation: {e})")
    return 0


def run_kitti(args):
    """KITTI tracking with offline perception artifacts (the reference's
    usual configuration: SOLOv2 .pt seg + FCOS3D txt + LEAStereo
    disparity read from disk)."""
    from dynamic_vins_tpu_torch.io import perception
    from dynamic_vins_tpu_torch.io.datasets import KittiTrackingDataset

    if args.config:
        cfg = VioConfig.from_yaml(args.config, args.seq)
    else:
        cfg = VioConfig()
        cfg.dataset = DatasetType.KITTI
        cfg.slam = SlamMode(args.slam)
        cfg.use_imu = False          # KITTI tracking: VO mode
        # KITTI P2 intrinsics (image_02) typical values
        cfg.intrinsics_left = [721.5377, 721.5377, 609.5593, 172.854]
        cfg.body_T_cam0 = np.eye(4).reshape(-1).tolist()
        T1 = np.eye(4)
        T1[0, 3] = 0.537
        cfg.body_T_cam1 = T1.reshape(-1).tolist()

    ds = KittiTrackingDataset(args.left, args.right)
    sysm = _system(cfg, args)
    count = 0
    t0 = time.perf_counter()
    for fr in ds.frames():
        if args.max_frames and count >= args.max_frames:
            break
        seq_str = f"{count:06d}"
        seg = None
        if args.seg_dir:
            seg = perception.read_solo_seg_pt(args.seg_dir, seq_str)
        boxes3d = None
        if args.det3d_dir:
            boxes3d = perception.read_fcos3d_txt(
                os.path.join(args.det3d_dir, seq_str + ".txt"))
        disparity = None
        if args.disp_dir:
            disparity = perception.read_disparity_png(
                os.path.join(args.disp_dir, seq_str + ".png"))
        sysm.process(FrameInput(fr.t, fr.img_left, fr.img_right,
                                seg=seg, boxes3d=boxes3d,
                                disparity=disparity))
        count += 1
    wall = time.perf_counter() - t0
    summary = sysm.close()
    print(f"frames={count} fps={count / max(wall, 1e-9):.2f} "
          f"stages={summary}")
    print(f"outputs: {args.output}_ego_tum.txt"
          + (f", {args.output}_mot.txt"
             if cfg.slam == SlamMode.DYNAMIC else ""))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--seq", default="")
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "euroc", "kitti", "viode",
                             "custom"])
    ap.add_argument("--intrinsics", default=None,
                    help="custom dataset: fx,fy,cx,cy[,k1,k2,p1,p2]")
    ap.add_argument("--root", default=None)
    ap.add_argument("--left", default=None)
    ap.add_argument("--right", default=None)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--slam", default="raw",
                    choices=["raw", "naive", "dynamic"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--output", default="output/run")
    ap.add_argument("--seg-dir", default=None,
                    help="offline SOLOv2 .pt tensors dir")
    ap.add_argument("--det3d-dir", default=None,
                    help="offline FCOS3D txt dir")
    ap.add_argument("--disp-dir", default=None,
                    help="offline LEAStereo disparity PNG dir")
    ap.add_argument("--pipelined", action="store_true",
                    help="device-resident pipelined steady state"
                         " (frontend + backend overlap)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="keyframe db + loop edges + pose-graph solve")
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the BA over N cards (not ported yet: "
                         "N > 1 raises)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    if args.dataset == "synthetic":
        return run_synthetic(args)
    if args.dataset == "euroc":
        return run_euroc(args)
    if args.dataset in ("viode", "custom"):
        if not args.root:
            raise SystemExit(f"{args.dataset} requires --root")
        return run_viode(args, custom=args.dataset == "custom")
    if not args.left:
        raise SystemExit("kitti requires --left (and optionally "
                         "--right/--seg-dir/--det3d-dir/--disp-dir)")
    return run_kitti(args)


if __name__ == "__main__":
    sys.exit(main())
