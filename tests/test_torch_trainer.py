"""Port parity for the trainer (`training/trainer.py`), the backward pass
of every training task and the checkpoints that cross between the
packages, against the JAX package on the same inputs with the same
parameters (JAX's init carried across with `convert.flax_params`).

Tolerances:
  * the optimizer against `optax.chain(clip_by_global_norm, adamw(
    warmup_cosine_decay_schedule))` in float64: every parameter within
    1e-12 after each of 30 steps of fixed gradients (warmup, the cosine
    decay down to its end value and beyond, steps with and without the
    clip), the schedule (float32, as optax's) equal;
  * `Trainer.step` on tests/test_training.py's stereo setup (48x64,
    max_disp 16, batch 2), 3 steps from JAX's init, float32: losses rtol
    1e-5, parameters rtol 5e-3 atol 5e-5 (the JAX package's own
    data-parallel tolerance);
  * one value_and_grad of each CLI task at a small size, float32: the
    loss rtol 1e-5, each gradient leaf within 1e-4 of that leaf's scale;
    the flow task's batched RAFT against JAX's vmap, 1e-4 of the flow's
    scale;
  * checkpoints: the port's file has exactly the key set of JAX's tree
    and loads in JAX's `load_params` leaf for leaf equal; a JAX file
    loads in the port equal;
  * on a batch where JAX's float32 gradient is ill-conditioned, the
    port's float32 gradient within 1e-4 of its float64 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynamic_vins_tpu.models.solov2 import load_params, save_params
from dynamic_vins_tpu.training import cli as jcli
from dynamic_vins_tpu.training import trainer as jtrainer
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.training import cli as tcli
from dynamic_vins_tpu_torch.training import losses as tl
from dynamic_vins_tpu_torch.training import trainer as ttrainer
from test_torch_models import carry, flat, jit_flax_init  # noqa: F401

torch.set_num_threads(1)   # the xdist workers share the cores


def close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, scale)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def test_optimizer_matches_optax():
    cfg = ttrainer.TrainConfig(learning_rate=0.05, weight_decay=0.01,
                               grad_clip=1.0, warmup_steps=5,
                               total_steps=20, min_lr_frac=0.05)
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    p0 = [rng.normal(size=s) for s in shapes]
    # one scale a step, the norms from about 0.02 to 17: the clip on
    # about half the steps
    grads = []
    for _ in range(30):
        scale = 10.0 ** rng.uniform(-2.5, 0.5)
        grads.append([rng.normal(size=s) * scale for s in shapes])
    norms = [np.sqrt(sum((g * g).sum() for g in gs)) for gs in grads]
    assert 5 < sum(n >= cfg.grad_clip for n in norms) < 25

    jcfg = jtrainer.TrainConfig(*cfg)
    tx = jtrainer.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.tensor(p) for p in p0]
    opt = ttrainer.make_optimizer(tp, cfg)
    for gs in grads:
        upd, state = update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(g) for g in gs])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)

    sched = optax.warmup_cosine_decay_schedule(
        init_value=cfg.learning_rate * 0.1, peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * cfg.min_lr_frac)
    for count in range(31):     # optax's count is int32: float32 values
        got, want = opt.schedule(count), sched(jnp.int32(count))
        assert got.dtype == want.dtype == np.float32 and got == want, count
    # the first update uses 0.1 * lr; the end value is reached
    np.testing.assert_allclose(opt.schedule(0), 0.1 * cfg.learning_rate,
                               rtol=1e-6)
    assert opt.schedule(30) == np.float32(0.0025)


# ---------------------------------------------------------------------------
# Trainer.step (tests/test_training.py's stereo setup)
# ---------------------------------------------------------------------------
def test_trainer_step_matches_jax():
    from dynamic_vins_tpu_torch.models.stereo_net import StereoNet
    from test_training import _stereo_setup

    _, params, jloss, batch = _stereo_setup()
    jtr = jtrainer.Trainer(jloss, params, jtrainer.TrainConfig())

    def loss_fn(m, b):
        left, right, disp, valid = b
        pred = m(tcli._norm(left), tcli._norm(right))
        l = tl.stereo_loss(pred, disp, valid)
        return l, {"epe": l}

    ttr = ttrainer.Trainer(loss_fn, carry(params, StereoNet(max_disp=16)),
                           ttrainer.TrainConfig(), device="cpu")
    for _ in range(3):
        lj, auxj = jtr.step(batch)
        lt, auxt = ttr.step(batch)
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
        np.testing.assert_allclose(auxt["epe"], auxj["epe"], rtol=1e-5)
    got = convert.to_flax(ttr.model)
    want = flat(jtr.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-5,
                                   err_msg=k)


def test_data_parallel_is_one_device():
    mesh = ttrainer.data_parallel_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),)
    with pytest.raises(NotImplementedError, match="item 18"):
        ttrainer.data_parallel_mesh(2, device="cpu")


# ---------------------------------------------------------------------------
# one value_and_grad of each CLI task, and checkpoints both ways
# ---------------------------------------------------------------------------
TASKS = {"stereo": ((32, 64), 2), "flow": ((32, 32), 2),
         "solo": ((32, 32), 2), "det3d": ((64, 64), 2),
         "reid": ((64, 32), 8)}
# the stereo cost aggregation's output bias: its gradient is 0 (the
# soft-argmin's softmax ignores a constant), so both sides give rounding
# noise (~1e-6 on the CPU); held to 1e-4 of the largest leaf's scale
ZERO_GRAD = {"Aggregation_0.out.bias"}


def same_tree(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            same_tree(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_tree(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("task", list(TASKS))
def test_task_gradient_and_checkpoints(task, tmp_path):
    hw, batch = TASKS[task]
    p0, jloss, jgen = jcli.build_task(task, hw, np.random.default_rng(5),
                                      batch)
    model, tloss, tgen = tcli.build_task(
        task, hw, np.random.default_rng(5), batch, device="cpu")
    jb, tb = jgen(), tgen()
    same_tree(tb, jb)
    same_tree(tgen(), jgen())       # the CLI's draws stay in step

    # checkpoints: the port's key set is JAX's, values cross both ways
    ref = flat(p0)
    shapes = {k: v.shape for k, v in ref.items()}
    assert {k: v.shape for k, v in convert.to_flax(model).items()} \
        == shapes
    tr = ttrainer.Trainer(tloss, model, device="cpu")
    path = str(tmp_path / "port.npz")
    save_params(p0, str(tmp_path / "jax.npz"))
    tr.load(str(tmp_path / "jax.npz"))
    same_tree(convert.to_flax(model), ref)
    tr.save(path)
    with np.load(path) as f:
        assert set(f.files) == set(ref)
    same_tree(flat(load_params(p0, path)), ref)

    # one value_and_grad from the same parameters, on the first batch
    # (on FCOS3D's second batch JAX's float32 gradient parts from the
    # float64 one: test_float32_gradient_on_a_flat_batch below)
    (lj, _), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p0, jb)
    lt, _ = tloss(model, tr.place_batch(tb))
    params = dict(model.named_parameters())
    gt = torch.autograd.grad(lt, list(params.values()), allow_unused=True,
                             materialize_grads=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = convert.flax_params(flat(gj), model)
    top = max(float(w.abs().max()) for w in want.values())
    for (name, _), g in zip(params.items(), gt):
        if name in ZERO_GRAD:
            assert float((g - want[name]).abs().max()) <= 1e-4 * top
        else:
            close(g.numpy(), want[name].numpy(), 1e-4)

    if task == "flow":   # the batched RAFT against JAX's vmap
        from dynamic_vins_tpu.models.raft import RAFT

        norm = lambda x: (jnp.asarray(x) / 255.0 - 0.45) / 0.225
        want = jax.jit(jax.vmap(lambda a, c: RAFT(iters=4).apply(
            p0, a[None], c[None])))(norm(jb[0]), norm(jb[1]))
        with torch.no_grad():
            got = model(tcli._norm(torch.from_numpy(tb[0])),
                        tcli._norm(torch.from_numpy(tb[1])))
        close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), 1e-4)


def test_float32_gradient_on_a_flat_batch():
    """FCOS3D's second batch of seed 5 at 64x64: JAX's float32 gradient
    parts from a float64 evaluation of the same net by 1.7e-2 of the
    scale of Backbone_0.BasicBlock_4-5's leaves (flat regions under
    GroupNorm's E[x^2] - E[x]^2; tests/grad_witness.py prints both). The
    port's float32 gradient stays within 1e-4 of its float64 one on
    every leaf."""
    from dynamic_vins_tpu_torch.training.trainer import to_device

    model, loss_fn, gen = tcli.build_task(
        "det3d", (64, 64), np.random.default_rng(5), 2, device="cpu")
    gen()
    batch = to_device(gen(), "cpu")

    def grads(m, b):
        params = dict(m.named_parameters())
        return dict(zip(params, torch.autograd.grad(
            loss_fn(m, b)[0], list(params.values()), allow_unused=True,
            materialize_grads=True)))

    g32 = grads(model, batch)
    b64 = (batch[0].double(),
           [{k: v.double() if v.is_floating_point() else v
             for k, v in t.items()} for t in batch[1]])
    g64 = grads(model.double(), b64)
    for name, ref in g64.items():
        close(g32[name].numpy(), ref.numpy(), 1e-4)
