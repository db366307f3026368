"""Retrain the shipped checkpoints of the online nets with the port.

The shipped checkpoints (`dynamic_vins_tpu/weights/`, read by the port
through `models/pretrained.py`) were trained on the exact-ground-truth
synthetic generators (`training/data.py`). This tool reproduces that
recipe with the port's trainer, task for task (the same `RECIPES`, the
same float16 compression, the same `MANIFEST.json` fields):

    python -m dynamic_vins_tpu_torch.tools.train_shipped_weights \
        [--tasks solo,stereo,...] [--scale 1.0] [--out-dir build/weights] \
        [--cpu]

It writes into `build/weights/` by default and refuses a directory
inside the JAX package: the shipped files stay as they are. A file it
writes loads through `load_online(task, ..., params_path=<file>)` and in
the JAX package's `load_params`.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "build" / "weights"

# (cli task name, manifest model kwargs, steps, batch, lr)
RECIPES = {
    "solo": ({"num_classes": 8, "grid_sizes": [12, 8, 6, 4]},
             800, 4, 1e-3),
    "det3d": ({"num_classes": 6}, 800, 4, 1e-3),
    "stereo": ({}, 700, 4, 1e-3),
    "flow": ({}, 500, 2, 1e-3),
    "reid": ({}, 600, 16, 1e-3),
}


def compress_f16(src: str, dst: str) -> None:
    data = np.load(src)
    out = {}
    for k in data.files:
        a = data[k]
        out[k] = a.astype(np.float16) if a.dtype == np.float32 else a
    np.savez_compressed(dst, **out)


def main(argv=None):
    from dynamic_vins_tpu_torch.models.pretrained import WEIGHTS_DIR
    from dynamic_vins_tpu_torch.training import cli as tcli

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tasks", default=",".join(RECIPES))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply step counts (quick smoke: 0.02)")
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT))
    ap.add_argument("--tmp-dir", default=None,
                    help="float32 checkpoints (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir).resolve()
    jax_pkg = WEIGHTS_DIR.resolve().parent
    if out_dir == jax_pkg or jax_pkg in out_dir.parents:
        raise SystemExit(f"refusing to write into the JAX package "
                         f"({out_dir}): its shipped weights stay as they "
                         f"are")
    out_dir.mkdir(parents=True, exist_ok=True)
    man_path = out_dir / "MANIFEST.json"
    manifest = {}
    if man_path.exists():
        with open(man_path) as f:
            manifest = json.load(f)

    with tempfile.TemporaryDirectory() as scratch:
        tmp_dir = args.tmp_dir or scratch
        os.makedirs(tmp_dir, exist_ok=True)
        for task in [t.strip() for t in args.tasks.split(",")
                     if t.strip()]:
            model_kw, steps, batch, lr = RECIPES[task]
            steps = max(int(steps * args.scale), 2)
            raw = os.path.join(tmp_dir, f"{task}_f32.npz")
            t0 = time.perf_counter()
            tcli.main(["--task", task, "--steps", str(steps),
                       "--batch", str(batch), "--lr", str(lr),
                       "--out", raw, "--log-every", "50"]
                      + (["--cpu"] if args.cpu else []))
            dst = out_dir / f"{task}.npz"
            compress_f16(raw, str(dst))
            manifest[task] = {
                "file": f"{task}.npz",
                "model": model_kw,
                "trained": {"steps": steps, "batch": batch, "lr": lr,
                            "data": "training/data.py synthetic",
                            "seconds": round(time.perf_counter() - t0,
                                             1)},
            }
            with open(man_path, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            print(f"[{task}] {os.path.getsize(dst) / 1e6:.2f} MB -> {dst}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
