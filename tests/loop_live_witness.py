#!/usr/bin/env python3
"""tests/test_loop_live.py's protocol (376x240, a 36-frame lap, 45
frames, keyframes every 2nd frame, window 7) through one System with
the estimator in float64, once with the live loop correction and once
without, with a chosen LK form. Prints the position error of every
frame of both runs, the error on the first frame after the first
correction, and the reference's gate: the live run's last frame at
least 2x closer to the truth than the uncorrected run's.

The port tracks with the track kernel's semantics on the card (a
48x256 window, the level-0 back-check seeded with the forward flow)
and with the Scharr/gather form on the CPU, as the JAX System does on
the CPU. Running either System with either form tells whether a
difference between the card and the CPU comes from the LK form or
from the rest of the path:

    python tests/loop_live_witness.py --impl torch --lk plain
    python tests/loop_live_witness.py --impl torch --lk xla
    python tests/loop_live_witness.py --impl torch --device cuda --lk xla
    python tests/loop_live_witness.py --impl jax --lk plain

`--lk plain` on the port is the kernel's plain torch version, `cuda`
the kernel itself (card only), `auto` the device's default; on the JAX
side `plain` is the Pallas level in interpret mode with the seeded
level-0 back-check and `xla` its CPU form. The port's frames are
chip_smoke.py's phase 19d frames, rendered on --device; the JAX
System renders its own with tests/test_loop_live.py's code. The torch
path imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402


def run_torch(args, live, prefix):
    """The port's System over phase 19d's frames: per-frame errors and
    the call after which each loop edge was accepted."""
    import torch

    from dynamic_vins_tpu_torch.frontend import lk
    from dynamic_vins_tpu_torch.sim import render
    from dynamic_vins_tpu_torch.system import FrameInput, System

    dev = torch.device(args.device)
    rig = render.small_rig(0.5)
    frames, truth = chip_smoke.loop_scene(
        torch, dev, rig, chip_smoke.LOOP_REF_FRAMES, chip_smoke.LOOP_REF_LAP,
        chip_smoke.LOOP_REF_PERIOD, 220, 1.6, 100.0)
    cfg = chip_smoke.loop_ref_config(rig, live)
    system = System(cfg, output_prefix=prefix, device=dev,
                    dtype=torch.float64)
    tc = system.tracker.cfg
    system.tracker._tracker = lk.make_tracker(
        tc.levels, tc.radius, tc.iters, tc.fb_thresh, tc.border,
        backend=args.lk, device=dev)
    system.estimator.set_initial_pose(*truth[0])
    corrections = []
    for k, (t, il, ir, imu, disp) in enumerate(frames):
        n = len(system.loop_closer.edges)
        system.process(FrameInput(t, il, ir, imu=imu, disparity=disp))
        if len(system.loop_closer.edges) > n:
            corrections.append(k)
    system.drain()
    system.close()
    return np.stack([t[0] for t in truth]), corrections


def run_jax(args, live, prefix):
    """The JAX System over tests/test_loop_live.py's own frames."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import test_loop_live

    if args.lk == "plain":
        import scenario_ate
        scenario_ate._use_pallas_interpret_lk()
    elif args.lk != "xla":
        raise SystemExit("--impl jax takes --lk plain or xla")
    path = Path(prefix)
    test_loop_live._run(live, path.parent, K=chip_smoke.LOOP_REF_FRAMES)
    (path.parent / f"live{int(live)}_ego_tum.txt").rename(
        prefix + "_ego_tum.txt")
    ts, poses, _, _ = test_loop_live._circle_states(
        chip_smoke.LOOP_REF_FRAMES)
    return np.stack([p[0] for p in poses]), None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--lk", default="auto",
                    choices=("auto", "plain", "xla", "cuda"))
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    if args.impl == "torch":
        import torch
        torch.set_num_threads(args.threads)
    run = run_torch if args.impl == "torch" else run_jax
    errs, edges = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for live in (True, False):
            prefix = str(Path(tmp) / f"run{int(live)}")
            gt, corr = run(args, live, prefix)
            p = np.loadtxt(prefix + "_ego_tum.txt")[:, 1:4]
            errs[live] = np.linalg.norm(p - gt, axis=1)
            edges[live] = corr
    on, off = errs[True], errs[False]
    # the first frame the correction moved by a millimetre or more
    moved = np.abs(on - off) > 1e-3
    c = int(np.argmax(moved)) if moved.any() else len(on) - 1
    print(f"{args.impl} on {args.device}, LK {args.lk}, estimator float64: "
          f"edges accepted after calls {edges[True]}; error on frame {c}, "
          f"the first the correction moved: live {on[c]:.4f} m, "
          f"uncorrected {off[c]:.4f} m; on the last frame live "
          f"{on[-1]:.4f} m, uncorrected {off[-1]:.4f} m, ratio "
          f"{off[-1] / on[-1]:.2f} (test_loop_live.py's gate: 2x)")
    print("per frame, live", json.dumps([round(float(e), 4) for e in on]))
    print("per frame, uncorrected",
          json.dumps([round(float(e), 4) for e in off]))


if __name__ == "__main__":
    main()
