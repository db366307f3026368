"""Where the port's and the JAX package's float32 gradients of a training
task part, which is nearer the truth: both against a float64 evaluation
of the same net (the port's modules in float64; the flax modules compute
in float32 only).

    python tests/grad_witness.py --task det3d --hw 64 64 --batch 2 \
        --seed 5 --draw 2

Builds the task with both training CLIs (`build_task`, the same draws),
carries JAX's init into the port, takes the `--draw`-th batch and prints,
for the leaves where JAX's float32 gradient parts most from the
float64 one, the distance of each float32 gradient from it relative to
the leaf's scale. Runs on the CPU.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dynamic_vins_tpu.training import cli as jcli  # noqa: E402
from dynamic_vins_tpu_torch import convert  # noqa: E402
from dynamic_vins_tpu_torch.training import cli as tcli  # noqa: E402
from dynamic_vins_tpu_torch.training.trainer import to_device  # noqa: E402
from test_torch_models import flat  # noqa: E402


def grads(loss_fn, model, batch):
    params = dict(model.named_parameters())
    loss, _ = loss_fn(model, batch)
    return dict(zip(params, torch.autograd.grad(
        loss, list(params.values()), allow_unused=True,
        materialize_grads=True)))


def as_double(batch):
    if isinstance(batch, dict):
        return {k: as_double(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(as_double(v) for v in batch)
    return batch.double() if batch.is_floating_point() else batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", default="det3d")
    ap.add_argument("--hw", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--draw", type=int, default=2)
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)

    hw = tuple(args.hw)
    p0, jloss, jgen = jcli.build_task(args.task, hw,
                                      np.random.default_rng(args.seed),
                                      args.batch)
    model, tloss, tgen = tcli.build_task(
        args.task, hw, np.random.default_rng(args.seed), args.batch, "cpu")
    model.load_state_dict(convert.flax_params(flat(p0), model))
    for _ in range(args.draw):
        jb, tb = jgen(), to_device(tgen(), "cpu")
    _, gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p0, jb)
    g_jax = convert.flax_params(flat(gj), model)
    g32 = grads(tloss, model, tb)
    g64 = grads(tloss, model.double(), as_double(tb))
    rows = []
    for name, ref in g64.items():
        scale = max(float(ref.abs().max()), 1e-30)
        err = lambda g: float((g.double() - ref).abs().max()) / scale
        rows.append((err(g_jax[name]), err(g32[name]), name))
    print(f"{args.task} {hw[1]}x{hw[0]} batch {args.batch} seed "
          f"{args.seed} draw {args.draw}: float32 gradients against the "
          f"port's float64, relative to each leaf's scale")
    for e_jax, e_port, name in sorted(rows, reverse=True)[:args.top]:
        print(f"  {name}: JAX {e_jax:.3e}, port {e_port:.3e}")
    print(f"  worst leaf: JAX {max(r[0] for r in rows):.3e}, port "
          f"{max(r[1] for r in rows):.3e}")


if __name__ == "__main__":
    main()
