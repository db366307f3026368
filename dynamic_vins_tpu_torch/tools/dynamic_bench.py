"""DYNAMIC-mode end-to-end timing: ego VIO plus per-object estimation.

Drives the DYNAMIC estimator (the megastep ego solve and the instance
pipeline: push, propagate, initialize, triangulate, classify, optimize,
reject) over the simulated frontend's frames and the synthetic moving
objects (`sim/objects.make_object_frames`), twice on the card (the
first run captures the step graphs), and prints one JSON summary: the
median, mean and p90 ms a frame over the steady frames, the unaligned
ego ATE, and each object's position and velocity error at the last
frame. The reference's budget for this work is its 10 Hz design point.

The time of a frame is host time around `process_frame` with
`torch.cuda.synchronize()` before the clock is read, so it counts the
card's work for the frame (the JAX tool's host clock reads dispatch
time under its asynchronous execution). On the CPU there is nothing to
capture, and the frames run once.

    python -m dynamic_vins_tpu_torch.tools.dynamic_bench [--frames N]
        [--objects K] [--window W] [--warm-frames N] [--cpu]
        [--dtype float32|float64]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run(frames: int = 40, objects: int = 2, window: int = 11,
        warm_frames=None, device=None, dtype=None) -> dict:
    """The benchmark's JSON document (see the module docstring), in
    `dtype` (default: the estimator's for the device)."""
    import torch

    from dynamic_vins_tpu_torch.estimator import estimator as est_mod
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import objects as objsim
    from dynamic_vins_tpu_torch.sim import synthetic as sim
    from dynamic_vins_tpu_torch.utils.precision import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    seq = sim.generate_sequence(num_frames=frames, imu_hz=200.0,
                                acc_noise=0.05, gyr_noise=0.005,
                                num_landmarks=250, seed=0)
    fe_frames = frontend_sim.make_frames(seq, pixel_noise=0.5, seed=0)
    inst_frames, truths = objsim.make_object_frames(
        seq, num_objects=objects, seed=0)
    rig = seq.rig
    p_bc = np.stack([rig.p_bc.numpy(), rig.right_extrinsics()[0].numpy()])
    q_bc = np.stack([rig.q_bc.numpy(), rig.right_extrinsics()[1].numpy()])

    def drive():
        est = est_mod.Estimator(est_mod.EstimatorConfig(
            num_frames=window, lm_capacity=512, obs_capacity=8192,
            dynamic=True, dtype=dtype), p_bc, q_bc, device=device)
        est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                             sim.state_at(seq.frame_times[0])[2].numpy())
        outs, times = [], []
        for (frame, imu), inst in zip(fe_frames, inst_frames):
            t0 = time.perf_counter()
            o = est.process_frame(frame, imu, instances=inst)
            if on_card:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if o is not None:
                outs.append(o)
        outs.extend(est.flush())
        return est, outs, times

    if on_card:
        drive()                  # captures the step graphs
    est, outs, times = drive()

    warm = warm_frames if warm_frames is not None else window + 4
    steady = np.array(times[warm:]) * 1000
    t = np.array([o.timestamp for o in outs])
    ate = frontend_sim.ate_rmse(
        np.stack([o.p for o in outs]),
        sim.state_at(torch.from_numpy(t))[0].numpy())

    obj_err = {}
    states = est.get_instance_states()
    for tr in truths:
        info = states.get(tr.track_id)
        if info is None:
            continue
        pe = float(np.linalg.norm(np.asarray(info["p"]) - tr.gt_p[-1]))
        ve = float(np.linalg.norm(np.asarray(info["v"]) - tr.v_obj)) \
            if "v" in info else None
        obj_err[tr.track_id] = dict(
            pos_err_m=round(pe, 3),
            vel_err_mps=round(ve, 3) if ve is not None else None)

    return {
        "metric": "dynamic_e2e_ms_per_frame",
        "value": round(float(np.median(steady)), 1),
        "unit": "ms/frame",
        "detail": {
            "mean_ms": round(float(steady.mean()), 1),
            "p90_ms": round(float(np.percentile(steady, 90)), 1),
            "frames": frames, "objects": objects,
            "ego_ate_m": round(float(ate), 4),
            "objects_err": obj_err,
            "device": torch.cuda.get_device_name(device) if on_card
            else "cpu",
        }}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--window", type=int, default=11)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None,
                    help="the estimator's float type (default: float32 on "
                         "the card, float64 on the CPU)")
    ap.add_argument("--warm-frames", type=int, default=None,
                    help="frames to skip before timing (default: "
                         "window + 4)")
    args = ap.parse_args(argv)
    import torch

    res = run(args.frames, args.objects, args.window, args.warm_frames,
              device="cpu" if args.cpu else None,
              dtype=getattr(torch, args.dtype) if args.dtype else None)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
