"""Accuracy probe: the bench's end-to-end protocol at a chosen float
type and device, printing ONE JSON line
{"ate_aligned": ..., "ate_raw": ..., "per_seed": [...], "x64": ...}.

The protocol: the 42-frame synthetic sequence (200 Hz IMU with noise,
250 landmarks, seed 0), simulated frontend features with 0.5 px noise
drawn per seed, the pipelined estimator with window 11, 512 landmark
slots and 8192 observation rows. A bench runs it on the CPU in float64
beside the card's float32 run, so the card's float32 gap is measured
against a float64 run of the same aligned protocol.

    python -m dynamic_vins_tpu_torch.tools.accuracy_probe \
        [--platform cuda|cpu] [--x64] [--seeds N]

It runs on the card unless `--platform cpu` is given.
"""

from __future__ import annotations

import argparse
import json


def run_protocol(seeds, pipelined: bool = True, dtype=None, device=None):
    """(median aligned ATE, median unaligned ATE, per-seed aligned ATEs
    rounded to 4 places) over `seeds` (the frontend noise draws)."""
    import numpy as np
    import torch

    from dynamic_vins_tpu_torch.estimator import estimator as est_mod
    from dynamic_vins_tpu_torch.io import evaluation as ev
    from dynamic_vins_tpu_torch.sim import frontend_sim
    from dynamic_vins_tpu_torch.sim import synthetic as sim_mod
    from dynamic_vins_tpu_torch.utils.precision import resolve_device

    device = resolve_device(device)
    seq = sim_mod.generate_sequence(num_frames=42, imu_hz=200.0,
                                    acc_noise=0.05, gyr_noise=0.005,
                                    num_landmarks=250, seed=0)
    rig = seq.rig
    p_bc = np.stack([rig.p_bc.numpy(), rig.right_extrinsics()[0].numpy()])
    q_bc = np.stack([rig.q_bc.numpy(), rig.right_extrinsics()[1].numpy()])

    ates, ates_raw = [], []
    for seed in seeds:
        frames = frontend_sim.make_frames(seq, pixel_noise=0.5, seed=seed)
        est = est_mod.Estimator(est_mod.EstimatorConfig(
            num_frames=11, lm_capacity=512, obs_capacity=8192,
            pipelined=pipelined, dtype=dtype), p_bc, q_bc, device=device)
        est.set_initial_pose(
            seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
            sim_mod.state_at(seq.frame_times[0])[2].numpy())
        outs = []
        for frame, imu in frames:
            o = est.process_frame(frame, imu)
            if o is not None:
                outs.append(o)
        outs.extend(est.flush())
        t = np.array([o.timestamp for o in outs])
        p = np.stack([o.p for o in outs])
        gt = sim_mod.state_at(torch.from_numpy(t))[0].numpy()
        ates.append(float(ev.ate_rmse(t, p, t, gt, align=True)))
        ates_raw.append(float(frontend_sim.ate_rmse(p, gt)))
    return float(np.median(ates)), float(np.median(ates_raw)), \
        [round(a, 4) for a in ates]


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--x64", action="store_true",
                    help="float64 (default: float32)")
    ap.add_argument("--seeds", type=int, default=1)
    args = ap.parse_args(argv)

    dtype = torch.float64 if args.x64 else torch.float32
    ate, ate_raw, per_seed = run_protocol(list(range(args.seeds)),
                                          dtype=dtype, device=args.platform)
    print(json.dumps({"ate_aligned": round(ate, 4),
                      "ate_raw": round(ate_raw, 4),
                      "per_seed": per_seed,
                      "x64": bool(args.x64)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
