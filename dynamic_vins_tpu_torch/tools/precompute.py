"""Precompute perception artifacts for a sequence with the online nets.

Counterpart of the JAX package's `tools/precompute.py` (the reference's
offline preprocessing scripts `scripts/python/solov2_det2d_kitti.py`,
`fcos3d_det3d_kitti.py`, `leastereo_kitti.py`, `raft_flow_kitti.py`):
run each net once over an image directory and write per-frame artifacts
in the reference's own file formats, which the runner then serves
through the offline loaders (`io/perception.py`, `run.py --seg-dir /
--det3d-dir / --disp-dir`).

    python -m dynamic_vins_tpu_torch.tools.precompute \
        --left <dir>/image_02/0003 --right <dir>/image_03/0003 \
        --out <artifacts> --tasks seg,det3d,disp \
        [--intrinsics fx,fy,cx,cy] [--seg-weights ...] [--cpu]

Weights default to the shipped synthetic-trained checkpoints
(`models/pretrained.py`); point `--seg-weights` etc. at other `.npz`
files. The nets run on the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    from dynamic_vins_tpu_torch.io import perception
    from dynamic_vins_tpu_torch.io.datasets import KittiTrackingDataset
    from dynamic_vins_tpu_torch.models import pretrained

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--left", required=True, help="left image dir")
    ap.add_argument("--right", default=None, help="right image dir")
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--tasks", default="seg,det3d,disp",
                    help="comma list of seg|det3d|disp|flow")
    ap.add_argument("--intrinsics", default=None,
                    help="fx,fy,cx,cy (det3d; defaults to KITTI P2)")
    ap.add_argument("--seg-weights", default=None)
    ap.add_argument("--det3d-weights", default=None)
    ap.add_argument("--stereo-weights", default=None)
    ap.add_argument("--flow-weights", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the nets on the CPU (default: the card)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    ds = KittiTrackingDataset(args.left, args.right)
    frames = list(ds.frames())
    if args.max_frames:
        frames = frames[: args.max_frames]
    if not frames:
        raise SystemExit(f"no frames under {args.left}")
    hw = frames[0].img_left.shape[:2]

    intr = ([float(v) for v in args.intrinsics.split(",")]
            if args.intrinsics
            else [721.5377, 721.5377, 609.5593, 172.854])

    stages = {}
    overrides = {"seg": args.seg_weights, "det3d": args.det3d_weights,
                 "disp": args.stereo_weights, "flow": args.flow_weights}
    for t in tasks:
        kw = {"device": device}
        if overrides.get(t):
            kw["params_path"] = overrides[t]
        if t == "seg":
            stages[t] = pretrained.load_online("solo", hw, **kw)
        elif t == "det3d":
            stages[t] = pretrained.load_online("det3d", hw,
                                               intrinsics=intr[:4], **kw)
        elif t == "disp":
            if not args.right:
                raise SystemExit("disp task needs --right")
            stages[t] = pretrained.load_online("stereo", hw, **kw)
        elif t == "flow":
            stages[t] = pretrained.load_online("flow", hw, **kw)
        else:
            raise SystemExit(f"unknown task {t!r}")

    seg_dir = os.path.join(args.out, "seg")
    det3d_dir = os.path.join(args.out, "det3d")
    disp_dir = os.path.join(args.out, "disp")
    flow_dir = os.path.join(args.out, "flow")

    t0 = time.perf_counter()
    prev = None
    for i, fr in enumerate(frames):
        name = f"{i:06d}"
        img = fr.img_left           # [H,W] grey; the online wrappers
        if "seg" in stages:          # normalize + batch internally
            seg = stages["seg"](img)
            perception.write_solo_seg_pt(seg_dir, name, seg)
        if "det3d" in stages:
            boxes = stages["det3d"](img)
            perception.write_fcos3d_txt(
                os.path.join(det3d_dir, name + ".txt"), boxes)
        if "disp" in stages and fr.img_right is not None:
            disp = stages["disp"](img, fr.img_right)
            perception.write_disparity_png(
                os.path.join(disp_dir, name + ".png"), disp)
        if "flow" in stages and prev is not None:
            flow = stages["flow"](prev, img)
            os.makedirs(flow_dir, exist_ok=True)
            np.save(os.path.join(flow_dir, name + ".npy"),
                    flow.cpu().numpy().astype(np.float32))
        prev = fr.img_left
    dt = time.perf_counter() - t0
    print(f"precomputed {len(frames)} frames x {tasks} in {dt:.1f}s "
          f"({dt / len(frames) * 1000:.1f} ms/frame) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
