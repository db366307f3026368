"""Port parity for the training losses and the generators built on them
(`training/losses.py`, `training/data.py`): the port's functions
against the JAX package's on the same numpy inputs, the value and the
gradient with respect to the inputs (`jax.grad` against autograd).

Tolerances:
  * losses where JAX keeps the input's dtype (smooth-L1, focal, sigmoid
    CE, dice, stereo, flow, triplet): float64, 1e-10 of the output's
    scale, value and gradient;
  * `solo_loss` and `fcos3d_loss`, which cast to float32 as JAX's do:
    1e-5 of the scale;
  * ties, where the gradient's split is a convention: `jnp.maximum`
    (logits exactly 0, a hinge exactly 0), `abs` at 0, the triplet
    loss's max/min over equal distances, an identity with no positive;
  * `solo_grid_layout`, `solo_targets`, `fcos3d_targets`, `seg_batch`
    and `det3d_batch`: equal arrays;
  * the shipped SOLOv2 and FCOS3D checkpoints on
    tests/test_shipped_weights.py's fresh batch: the port's loss equals
    JAX's to rtol 1e-4 and meets that test's gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.training import data as jdata
from dynamic_vins_tpu.training import losses as jl
from dynamic_vins_tpu_torch.training import data as tdata
from dynamic_vins_tpu_torch.training import losses as tl
from test_torch_models import jit_flax_init  # noqa: F401 (autouse)

torch.set_num_threads(1)   # the xdist workers share the cores

TOL64 = 1e-10
TOL32 = 1e-5


def close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-12)
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, scale)


def value_and_grads(jfn, tfn, jargs, targs, tol):
    """jfn(*jargs) and tfn(*targs) (scalars, or a tuple whose first
    entry is the loss) and their gradients w.r.t. every float argument;
    targs[i] is jargs[i] in the port's layout (a permutation)."""
    first = lambda r: r[0] if isinstance(r, tuple) else r
    jv, jg = jax.value_and_grad(lambda *a: first(jfn(*a)),
                                argnums=tuple(range(len(jargs))))(
        *[jnp.asarray(a) for a in jargs])
    tt = [torch.tensor(np.asarray(a), requires_grad=True) for a in targs]
    tv = first(tfn(*tt))
    tg = torch.autograd.grad(tv, tt)
    close(tv.detach().numpy(), np.asarray(jv), tol)
    return [np.asarray(g) for g in jg], [g.numpy() for g in tg]


def inputs(seed, shape, ties=0.0):
    """Normal float64 values with a share `ties` set to exactly 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, shape)
    x[rng.uniform(size=shape) < ties] = 0.0
    return x


# ---------------------------------------------------------------------------
# generic pieces, float64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["smooth_l1", "optax_sigmoid_ce",
                                  "focal_loss", "dice_loss"])
def test_elementwise_losses(name):
    x = inputs(1, (3, 40), ties=0.2)       # exact zeros: abs, maximum
    x[0, :4] = [1.0, -1.0, 0.5, -0.5]      # smooth-L1's branch edge
    t = (np.random.default_rng(2).uniform(size=x.shape) < 0.4).astype(
        np.float64)
    w = np.random.default_rng(3).normal(size=x.shape)
    if name == "smooth_l1":
        jf = lambda a: jnp.sum(jl.smooth_l1(a) * w)
        tf = lambda a: torch.sum(tl.smooth_l1(a) * torch.from_numpy(w))
        args = (x,)
    elif name == "dice_loss":
        prob = 1.0 / (1.0 + np.exp(-x))
        jf = lambda p, g: jnp.sum(jl.dice_loss(p, g) * w[:, 0])
        tf = lambda p, g: torch.sum(tl.dice_loss(p, g)
                                    * torch.from_numpy(w[:, 0]))
        args = (prob, t)
    else:
        jf = lambda a, g: jnp.sum(getattr(jl, name)(a, g) * w)
        tf = lambda a, g: torch.sum(getattr(tl, name)(a, g)
                                    * torch.from_numpy(w))
        args = (x, t)
    jg, tg = value_and_grads(jf, tf, args, args, TOL64)
    for a, b in zip(tg, jg):
        close(a, b, TOL64)


@pytest.mark.parametrize("valid_px", [None, 1, 0])
def test_stereo_loss(valid_px):
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 20, (2, 6, 9))
    gt = pred + inputs(5, pred.shape, ties=0.3)
    valid = rng.uniform(size=pred.shape) < 0.7
    if valid_px is not None:        # jnp.maximum(sum(w), 1.0) at a tie
        valid[:] = False            # and below it
        valid.flat[:valid_px] = True
    jg, tg = value_and_grads(
        lambda p, g: jl.stereo_loss(p, g, valid),
        lambda p, g: tl.stereo_loss(p, g, torch.from_numpy(valid)),
        (pred, gt), (pred, gt), TOL64)
    for a, b in zip(tg, jg):
        close(a, b, TOL64)


def test_flow_loss_takes_raft_layout():
    """The port's flow_loss takes RAFT's [B,2,H,W]; JAX's [B,H,W,2]."""
    rng = np.random.default_rng(6)
    pred = rng.normal(0, 4, (2, 7, 10, 2))
    gt = pred + inputs(7, pred.shape, ties=0.3)
    valid = rng.uniform(size=pred.shape[:3]) < 0.6
    jg, tg = value_and_grads(
        lambda p, g: jl.flow_loss(p, g, valid),
        lambda p, g: tl.flow_loss(p, g, torch.from_numpy(valid)),
        (pred, gt), (np.moveaxis(pred, -1, 1).copy(), gt), TOL64)
    close(np.moveaxis(tg[0], 1, -1), jg[0], TOL64)
    close(tg[1], jg[1], TOL64)


def _triplet_case(kind):
    rng = np.random.default_rng(8)
    if kind == "random":
        emb = rng.normal(size=(12, 5))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        return emb, np.repeat(np.arange(4), 3), 0.3
    if kind == "no_positive":       # identity 3 has one view
        emb = rng.normal(size=(7, 4))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        return emb, np.array([0, 0, 1, 1, 2, 2, 3]), 0.3
    # exact distances (binary fractions): equal positives, equal
    # negatives, and a hinge pos - neg + margin exactly 0
    emb = np.array([[1.0, 0.0], [0.5, 0.0], [0.5, 0.0], [0.25, 0.0],
                    [0.25, 0.0], [0.0, 1.0], [0.0, 0.5], [0.0, 0.5]])
    return emb, np.array([0, 0, 0, 1, 1, 2, 2, 2]), 0.25


@pytest.mark.parametrize("kind", ["random", "no_positive", "ties"])
def test_triplet_loss(kind):
    emb, ids, margin = _triplet_case(kind)
    jg, tg = value_and_grads(
        lambda e: jl.triplet_loss(e, jnp.asarray(ids), margin),
        lambda e: tl.triplet_loss(e, torch.from_numpy(ids), margin),
        (emb,), (emb,), TOL64)
    assert np.isfinite(tg[0]).all()
    close(tg[0], jg[0], TOL64)


# ---------------------------------------------------------------------------
# SOLOv2 and FCOS3D: targets exact, losses at float32 (JAX casts)
# ---------------------------------------------------------------------------
def test_solo_targets_equal():
    rng = np.random.default_rng(9)
    grids = (12, 8, 6, 4)
    for lj, lt in zip(jl.solo_grid_layout(grids), tl.solo_grid_layout(grids)):
        np.testing.assert_array_equal(lt, lj)
    H, W = 96, 128
    yy, xx = np.mgrid[:H, :W]
    for case in range(6):
        n = int(rng.integers(0, 6))
        masks = np.zeros((n, H, W), bool)
        for i in range(n):
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            ry, rx = rng.uniform(0.5, 40), rng.uniform(0.5, 50)
            masks[i] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        labels = rng.integers(0, 8, n)
        valid = rng.uniform(size=n) < 0.8
        for a, b in zip(tl.solo_targets(masks, labels, valid, grids, 8),
                        jl.solo_targets(masks, labels, valid, grids, 8)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fcos3d_targets_equal():
    rng = np.random.default_rng(10)
    for case in range(6):
        n = int(rng.integers(0, 7))
        uvd = np.stack([rng.uniform(0, 128, n), rng.uniform(0, 96, n),
                        rng.uniform(0.0, 40, n)], -1)
        dims = rng.uniform([0.5, 0.5, 1], [3, 3, 6], (n, 3))
        yaw = rng.uniform(-np.pi, np.pi, n)
        lab = rng.integers(0, 6, n)
        valid = rng.uniform(size=n) < 0.8
        got = tl.fcos3d_targets(uvd, dims, yaw, lab, valid, (96, 128),
                                num_classes=6)
        want = jl.fcos3d_targets(uvd, dims, yaw, lab, valid, (96, 128),
                                 num_classes=6)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_generators_equal(seed):
    grids = (12, 8, 6, 4)
    got = tdata.seg_batch(np.random.default_rng(seed), 3, (96, 128),
                          num_classes=8, grid_sizes=grids,
                          mask_hw=(24, 32))
    want = jdata.seg_batch(np.random.default_rng(seed), 3, (96, 128),
                           num_classes=8, grid_sizes=grids,
                           mask_hw=(24, 32))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):              # the draws stay in step
        (im_t, lv_t), (im_j, lv_j) = (
            tdata.det3d_batch(r_t, 2, (96, 128), num_classes=6),
            jdata.det3d_batch(r_j, 2, (96, 128), num_classes=6))
        np.testing.assert_array_equal(im_t, im_j)
        for g, w in zip(lv_t, lv_j):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


def test_solo_loss():
    grids = (12, 8, 6, 4)
    _, cate, inst, masks = jdata.seg_batch(
        np.random.default_rng(11), 2, (32, 32), num_classes=8,
        grid_sizes=grids, mask_hw=(8, 8))
    assert (inst >= 0).any()
    B, G = cate.shape
    rng = np.random.default_rng(12)
    kernels = rng.normal(0, 0.3, (B, G, 16))
    scores = inputs(13, (B, G, 8), ties=0.1) - 2.0
    scores[scores == -2.0] = 0.0                     # maximum's ties
    feat = rng.normal(0, 1, (B, 8, 8, 16))           # JAX: [B,h,w,E]
    jg, tg = value_and_grads(
        lambda k, s, f: jl.solo_loss(k, s, f, cate, inst, masks,
                                     num_classes=8),
        lambda k, s, f: tl.solo_loss(
            k, s, f, torch.from_numpy(cate), torch.from_numpy(inst),
            torch.from_numpy(masks), num_classes=8),
        (kernels, scores, feat),
        (kernels, scores, np.moveaxis(feat, -1, 1).copy()), TOL32)
    close(tg[0], jg[0], TOL32)
    close(tg[1], jg[1], TOL32)
    close(np.moveaxis(tg[2], 1, -1), jg[2], TOL32)


def test_fcos3d_loss():
    _, tgts = jdata.det3d_batch(np.random.default_rng(14), 2, (64, 128),
                                num_classes=6)
    assert sum(t["pos"].sum() for t in tgts) > 0
    rng = np.random.default_rng(15)
    outs = []                                        # JAX: channels last
    for t in tgts:
        b, h, w = t["cls"].shape
        outs.append((rng.normal(-2, 1, (b, h, w, 6)),
                     rng.normal(0, 1, (b, h, w, 1)),
                     rng.normal(0, 1, (b, h, w, 8))))
    outs[0][1][0, 0, 0, 0] = 0.0                     # a centerness tie
    flat = [a for lvl in outs for a in lvl]
    nchw = [np.moveaxis(a, -1, 1).copy() for a in flat]
    group = lambda xs: [tuple(xs[i:i + 3]) for i in range(0, len(xs), 3)]
    tt = [{k: torch.from_numpy(v) for k, v in t.items()} for t in tgts]
    jg, tg = value_and_grads(
        lambda *xs: jl.fcos3d_loss(group(xs), tgts, num_classes=6),
        lambda *xs: tl.fcos3d_loss(group(xs), tt, num_classes=6),
        flat, nchw, TOL32)
    for a, b in zip(tg, jg):
        close(np.moveaxis(a, 1, -1), b, TOL32)
    # the parts too
    tparts = tl.fcos3d_loss(group([torch.from_numpy(a) for a in nchw]),
                            tt, num_classes=6)[1]
    jparts = jl.fcos3d_loss(group([jnp.asarray(a) for a in flat]), tgts,
                            num_classes=6)[1]
    for a, b in zip(tparts, jparts):
        close(a.numpy(), np.asarray(b), TOL32)


# ---------------------------------------------------------------------------
# the shipped SOLOv2 and FCOS3D checkpoints (tests/test_shipped_weights.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("task,gate,ratio", [("solo", 1.6, 0.6),
                                             ("det3d", 4.0, 0.7)])
def test_shipped_losses(task, gate, ratio):
    """The port's loss of the shipped checkpoint equals JAX's on the
    batch test_shipped_weights scores (seed 123, batch 2, 96x128), and
    meets that test's gates against the port's untrained net."""
    from dynamic_vins_tpu.models import pretrained as jpre
    from dynamic_vins_tpu.models.solov2 import load_params
    from dynamic_vins_tpu.training import cli as jcli
    from dynamic_vins_tpu_torch.models import pretrained as tpre
    from dynamic_vins_tpu_torch.training import cli as tcli
    from dynamic_vins_tpu_torch.training.trainer import to_device

    p0, jloss, jgen = jcli.build_task(task, (96, 128),
                                      np.random.default_rng(123), 2)
    jbatch = jgen()
    j_trained = float(jax.jit(jloss)(
        load_params(p0, jpre.weights_path(task)), jbatch)[0])
    model, tloss, tgen = tcli.build_task(
        task, (96, 128), np.random.default_rng(123), 2, device="cpu")
    batch = to_device(tgen(), "cpu")
    with torch.no_grad():
        untrained = float(tloss(model, batch)[0])
        tpre.prepare(model, tpre.weights_path(task), torch.float32, "cpu")
        trained = float(tloss(model, batch)[0])
    np.testing.assert_allclose(trained, j_trained, rtol=1e-4)
    assert trained < gate, trained
    assert trained < ratio * untrained, (trained, untrained)
