"""Ahead-of-time "engines" of the online perception stages.

The counterpart of the reference's TensorRT engine builders
(`system/build_tools/build_solo.cpp`, `build_raft.cpp`: ONNX -> a
serialized engine deserialized at start-up) and of the JAX package's
`jax.export` artifacts:

  * **Artifact**: `torch.export` of each stage's device function (the
    online wrapper's normalization, net and fixed-capacity decode),
    saved as `<task>.pt2` by `torch.export.save`. The parameters are
    inputs of the exported program, as in JAX, so a checkpoint swaps in
    without a new export; `load_engine` gives `callable(params,
    *inputs)`.
  * **Warm start**: `--warm` runs each exported program once on the card
    so cuDNN builds its plans (the XLA compile-cache warm-up's role).

A stage that does not export (a host sync, a data-dependent shape)
raises; nothing is saved in another form instead.

    python -m dynamic_vins_tpu_torch.tools.build_engines \
        --out build/engines --hw 480 752 --tasks solo,stereo,flow --warm \
        [--cpu]

It exports for the card unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

TASKS = ("solo", "det3d", "stereo", "flow", "reid")
KITTI_P2 = (721.5377, 721.5377, 609.5593, 172.854)


class _Stage(torch.nn.Module):
    """fn(params, *inputs) as a module holding no parameters of its own
    (the net is kept out of the module tree: its weights are inputs)."""

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, params, *inputs):
        return self._fn(params, *inputs)


def stage_fn(task: str, image_hw, intrinsics=None, dtype=torch.float32,
             device=None):
    """(fn(params, *inputs), params, example inputs) of one stage, the
    online wrapper's device function with the shipped weights: raw
    [H,W] grey frames in (ReID: the normalized crops [B,64,32,3]), the
    wrapper's device outputs out (SOLOv2's `SegOutput` and FCOS3D's
    `Det3DOutput` as plain tuples of their fields)."""
    from torch.func import functional_call

    from dynamic_vins_tpu_torch.models import layers, pretrained

    wrap = pretrained.load_online(
        task, image_hw, device=device, dtype=dtype,
        **({"intrinsics": intrinsics or KITTI_P2} if task == "det3d"
           else {}))
    dev = wrap.device
    model = wrap.model
    params = {k: v.detach() for k, v in model.named_parameters()}
    norm = lambda img: layers.normalize_image(img, dtype, dev)
    img = torch.zeros(tuple(image_hw or ()), dtype=dtype, device=dev)
    if task == "solo":
        from dynamic_vins_tpu_torch.models.solov2 import decode

        def fn(p, img):
            kernels, sc, mfeat = functional_call(model, p, (norm(img),))
            return tuple(decode(kernels, sc, mfeat, wrap.image_hw,
                                score_thresh=wrap.score_thresh,
                                max_dets=wrap.max_dets))
        return fn, params, [img]
    if task == "det3d":
        from dynamic_vins_tpu_torch.models.det3d import decode

        def fn(p, img):
            return tuple(decode(functional_call(model, p, (norm(img),)),
                                model.strides, wrap.intrinsics,
                                score_thresh=wrap.score_thresh,
                                max_dets=wrap.max_dets))
        return fn, params, [img]
    if task == "stereo":
        def fn(p, left, right):
            return functional_call(model, p, (norm(left), norm(right)))[0]
        return fn, params, [img, img.clone()]
    if task == "flow":
        def fn(p, a, b):
            return functional_call(model, p, (norm(a), norm(b)))[0] \
                .permute(1, 2, 0)
        return fn, params, [img, img.clone()]
    if task == "reid":
        from dynamic_vins_tpu_torch.models.reid import CROP_HW

        def fn(p, crops):
            return functional_call(model, p, (crops.permute(0, 3, 1, 2),))
        crops = torch.zeros((wrap.max_boxes,) + CROP_HW + (3,),
                            dtype=dtype, device=dev)
        return fn, params, [crops]
    raise ValueError(f"unknown task {task!r}")


def export_stage(task: str, image_hw, out_dir: str, intrinsics=None,
                 device=None) -> str:
    """Export one stage to `<out_dir>/<task>.pt2`; raises if the stage
    does not export."""
    from dynamic_vins_tpu_torch.models import layers

    fn, params, inputs = stage_fn(task, image_hw, intrinsics,
                                  device=device)
    try:
        with torch.no_grad():
            ep = torch.export.export(_Stage(fn), (params, *inputs))
    finally:
        # the resize weights made while tracing are the trace's own
        # tensors: none may stay in the cache for eager calls
        layers._resize_weights.cache_clear()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{task}.pt2")
    torch.export.save(ep, path)
    return path


def load_engine(path: str):
    """An exported stage -> callable(params, *inputs)."""
    return torch.export.load(path).module()


def main(argv=None):
    from dynamic_vins_tpu_torch.utils.precision import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 752))
    ap.add_argument("--tasks", default=",".join(TASKS))
    ap.add_argument("--warm", action="store_true",
                    help="also run each exported stage once on the device "
                         "(cuDNN's plans)")
    ap.add_argument("--cpu", action="store_true",
                    help="export for the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    for task in [t.strip() for t in args.tasks.split(",") if t.strip()]:
        t0 = time.perf_counter()
        hw = tuple(args.hw)
        path = export_stage(task, hw, args.out, device=device)
        msg = f"{task}: exported {os.path.getsize(path)} bytes"
        if args.warm:
            _, params, inputs = stage_fn(task, hw, device=device)
            with torch.no_grad():
                load_engine(path)(params, *inputs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            msg += " + run once"
        print(f"{msg} ({time.perf_counter() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
