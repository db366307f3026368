"""Train an online perception net from the command line.

    python -m dynamic_vins_tpu_torch.training.cli --task stereo \
        --steps 200 --out build/stereo.npz [--resume ckpt.npz] [--cpu]

Tasks: stereo | flow | solo | det3d | reid, with the JAX package's
training CLI's models, hyperparameters and draws (`build_task` takes
the same `rng` in the same order). Data comes from the synthetic
generators of `training/data.py`. Runs on the card unless `--cpu` is
given. Checkpoints are the JAX package's `.npz` layout: they load in
either package, and through each net's `params_path`.
"""

from __future__ import annotations

import argparse
import time

from dynamic_vins_tpu_torch.models import layers
from dynamic_vins_tpu_torch.utils.precision import resolve_device


def _norm(img):
    """[B,H,W,3] pixels -> normalized [B,3,H,W] (the JAX CLI's `_norm`,
    then channels first)."""
    return ((img / 255.0 - 0.45) / 0.225).permute(0, 3, 1, 2)


def build_task(task: str, hw, rng, batch: int, device=None):
    """Returns (model on `device`, loss_fn(model, batch) -> (loss, aux),
    next_batch callable). The batch's numpy leaves reach loss_fn as
    tensors on the model's device (`Trainer.place_batch`). Parameters
    start from `layers.seeded(0)` (JAX: PRNGKey(0)); the init batch `b0`
    is drawn before the generator's first batch, as in JAX."""
    from dynamic_vins_tpu_torch.training import data as tdata
    from dynamic_vins_tpu_torch.training import losses

    dev = resolve_device(device)
    gen0 = layers.seeded(0)

    if task == "stereo":
        from dynamic_vins_tpu_torch.models.stereo_net import StereoNet

        model = StereoNet(max_disp=32, gen=gen0)
        tdata.stereo_batch(rng, batch, hw, 32)            # b0

        def loss_fn(m, b):
            left, right, disp, valid = b
            pred = m(_norm(left), _norm(right))
            l = losses.stereo_loss(pred, disp, valid)
            return l, {"epe_px": l}

        return model.to(dev), loss_fn, \
            lambda: tdata.stereo_batch(rng, batch, hw, 32)

    if task == "flow":
        from dynamic_vins_tpu_torch.models.raft import RAFT

        model = RAFT(iters=4, gen=gen0)
        tdata.flow_batch(rng, batch, hw)                  # b0

        def loss_fn(m, b):
            img1, img2, flow, valid = b
            # the whole batch at once: JAX vmaps RAFT over single images
            pred = m(_norm(img1), _norm(img2))
            l = losses.flow_loss(pred, flow, valid)
            return l, {"epe_px": l}

        return model.to(dev), loss_fn, \
            lambda: tdata.flow_batch(rng, batch, hw)

    if task == "solo":
        from dynamic_vins_tpu_torch.models.solov2 import Solov2

        grids = (12, 8, 6, 4)
        ncls = 8
        model = Solov2(num_classes=ncls, grid_sizes=grids, gen=gen0)
        mask_hw = (hw[0] // 4, hw[1] // 4)
        gen = lambda: tdata.seg_batch(rng, batch, hw, num_classes=ncls,
                                      grid_sizes=grids, mask_hw=mask_hw)
        gen()                                             # b0

        def loss_fn(m, b):
            im, ct, it, ml = b
            k, s, mf = m(_norm(im))
            l, aux = losses.solo_loss(k, s, mf, ct, it, ml,
                                      num_classes=ncls)
            return l, {"cate": aux[0], "mask": aux[1]}

        return model.to(dev), loss_fn, gen

    if task == "det3d":
        from dynamic_vins_tpu_torch.models.det3d import FCOS3D

        ncls = 6
        model = FCOS3D(num_classes=ncls, gen=gen0)
        gen = lambda: tdata.det3d_batch(rng, batch, hw,
                                        num_classes=ncls)
        gen()                                             # b0

        def loss_fn(m, b):
            im, t = b
            l, aux = losses.fcos3d_loss(m(_norm(im)), t, num_classes=ncls)
            return l, {"cls": aux[0], "ctr": aux[1], "reg": aux[2]}

        return model.to(dev), loss_fn, gen

    if task == "reid":
        from dynamic_vins_tpu_torch.models.reid import ReidNet

        model = ReidNet(gen=gen0)
        gen = lambda: tdata.reid_batch(rng, num_ids=max(batch // 4, 2),
                                       views=4, hw=(64, 32))
        gen()                                             # b0

        def loss_fn(m, b):
            im, lab = b
            return losses.triplet_loss(m(_norm(im)), lab), {}

        return model.to(dev), loss_fn, gen

    raise SystemExit(f"unknown task {task!r}")


def main(argv=None):
    import numpy as np

    from dynamic_vins_tpu_torch.training import (Trainer, TrainConfig,
                                                 data_parallel_mesh)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", required=True,
                    choices=["stereo", "flow", "solo", "det3d", "reid"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hw", type=int, nargs=2, default=(96, 128))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=None, help="checkpoint .npz path")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--data-parallel", action="store_true",
                    help="split the batch over all visible devices (one "
                         "device for now; more raise)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else None
    rng = np.random.default_rng(args.seed)
    model, loss_fn, next_batch = build_task(args.task, tuple(args.hw),
                                            rng, args.batch, device)
    mesh = data_parallel_mesh(device=device) if args.data_parallel \
        else None
    tr = Trainer(loss_fn, model,
                 TrainConfig(learning_rate=args.lr,
                             total_steps=args.steps), device=device,
                 mesh=mesh)
    if args.resume:
        tr.load(args.resume)
    t0 = time.perf_counter()
    for step in range(args.steps):
        loss, aux = tr.step(next_batch())
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = " ".join(f"{k}={v:.4f}" for k, v in aux.items())
            print(f"step {step:5d}  loss {loss:.4f}  {extra}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if args.out:
        tr.save(args.out)
        print("saved", args.out)


if __name__ == "__main__":
    main()
