"""Port parity for the online perception nets (`models/`): the port's
modules against the JAX package's flax ones on the same inputs (numpy,
seeded) with the same parameters, carried across by
`convert.flax_params` (torch cannot reproduce JAX's PRNG draws, so each
JAX tree is flattened with `solov2.save_params`'s keys and converted).

Tolerances (float32 on both sides unless stated):
  * layers: a conv of every padding case 1e-5; ConvGN 1e-5 (1e-12 in
    float64); resizes 1e-5; Backbone + FPN 1e-4 relative to the
    output's scale;
  * raw net outputs: 1e-4 relative to each output's scale (SOLOv2
    kernels / scores / mask features, FCOS3D per level, stereo
    disparity, ReID embeddings); RAFT: tests/test_torch_dense_flow.py;
  * decodes are compared exactly (top-k order, labels, masks) on the
    same raw head outputs fed to both; a mask pixel whose probability
    lies within 1e-5 of the 0.5 threshold, or a score within 1e-5 of a
    threshold, is excluded and counted, and the count must stay small;
    the decoded scores and boxes within 1e-5;
  * `matrix_nms`, `correlation_volume`: 1e-6;
  * the generators: equal arrays for the same seed;
  * the shipped checkpoints: every leaf equal to the JAX package's
    loaded tree (float16 -> float32); a checkpoint whose shapes are not
    the module's raises in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from dynamic_vins_tpu.models import det3d as jdet3d
from dynamic_vins_tpu.models import layers as jlayers
from dynamic_vins_tpu.models import pretrained as jpre
from dynamic_vins_tpu.models import reid as jreid
from dynamic_vins_tpu.models import solov2 as jsolo
from dynamic_vins_tpu.models import stereo_net as jstereo
from dynamic_vins_tpu.training import data as jdata
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.models import det3d as tdet3d
from dynamic_vins_tpu_torch.models import layers as tlayers
from dynamic_vins_tpu_torch.models import pretrained as tpre
from dynamic_vins_tpu_torch.models import reid as treid
from dynamic_vins_tpu_torch.models import solov2 as tsolo
from dynamic_vins_tpu_torch.models import stereo_net as tstereo
from dynamic_vins_tpu_torch.training import data as tdata

torch.set_num_threads(1)   # the xdist workers share the cores

HW = (96, 128)
RTOL_NET = 1e-4          # raw outputs, relative to each output's scale
THRESH_TOL = 1e-5        # decode: values this close to a threshold
DEC_ATOL = 1e-5


def flat(params):
    """A JAX param tree flattened with `save_params`'s `.npz` keys."""
    return {"/".join(map(str, k)).replace("[", "(").replace("]", ")"):
            np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.fixture(autouse=True)
def jit_flax_init(monkeypatch):
    """The JAX wrappers initialize their flax modules eagerly, which
    compiles op by op (~10 s a net); jit it inside these tests."""
    orig = fnn.Module.init

    def init(self, rng, *args, **kw):
        return jax.jit(lambda r, *a: orig(self, r, *a, **kw))(rng, *args)

    monkeypatch.setattr(fnn.Module, "init", init)


def jinit(module, *args, seed=0):
    """A flax module's parameters (jitted init: eager init takes ~10x)."""
    return jax.jit(module.init)(jax.random.PRNGKey(seed), *args)


def japply(module, params, *args):
    """flax apply, jitted (eager dispatch compiles op by op)."""
    return jax.jit(module.apply)(params, *args)


def shipped(task):
    """A shipped checkpoint as the JAX param tree `load_params` gives
    (every leaf is in the file: test_shipped_checkpoint_loads)."""
    tree = {}
    with np.load(jpre.weights_path(task)) as data:
        for k in data.files:
            parts = [q.strip("()'") for q in k.split("/")]
            node = tree
            for q in parts[:-1]:
                node = node.setdefault(q, {})
            node[parts[-1]] = jnp.asarray(data[k], jnp.float32)
    return tree


def carry(jparams, module):
    """The port module with the JAX parameters (float32, CPU, eval)."""
    module.load_state_dict(convert.flax_params(flat(jparams), module))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x), -1, 1)))


def close(a, b, rtol=RTOL_NET):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1e-6)
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale, (err, scale)


def texture(seed, hw=HW):
    rng = np.random.default_rng(seed)
    return tdata._rgb(tdata._smooth_noise(rng, *hw))[..., 0]


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("kernel,stride,h,w", [
    (3, 2, 16, 20), (7, 2, 16, 20), (3, 2, 15, 21), (7, 2, 15, 21),
    (1, 2, 16, 20), (1, 2, 15, 21), (3, 1, 15, 20), (1, 1, 8, 8)])
def test_conv_same_padding(kernel, stride, h, w):
    """flax "SAME" with a stride pads (total//2, rest): 3x3/2 on an even
    input (0, 1), 7x7/2 (2, 3)."""
    rng = np.random.default_rng(kernel * 100 + stride * 10 + h)
    x = rng.standard_normal((1, h, w, 5)).astype(np.float32)
    jm = fnn.Conv(6, (kernel, kernel), strides=(stride, stride),
                  padding="SAME")
    p = jinit(jm, jnp.asarray(x), seed=1)
    tm = carry(p, tlayers.Conv(5, 6, kernel, stride))
    with torch.no_grad():
        out = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    close(out, japply(jm, p, jnp.asarray(x)), 1e-5)


def test_conv3d_same_padding():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 6, 7, 9, 4)).astype(np.float32)
    jm = fnn.Conv(5, (3, 3, 3), padding="SAME")
    p = jinit(jm, jnp.asarray(x), seed=2)
    tm = carry(p, tlayers.Conv(4, 5, 3, dims=3))
    with torch.no_grad():
        out = tm(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    close(np.moveaxis(out.numpy(), 1, -1), japply(jm, p, jnp.asarray(x)),
          1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_convgn(dtype):
    """GroupNorm with flax's epsilon (1e-6, not torch's 1e-5), float32
    statistics, float32 output in either compute type."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 12, 10, 16)) * 3 + 1).astype(dtype)
    jm = jlayers.ConvGN(16, 3, 2, dtype=getattr(jnp, dtype))
    p = jinit(jm, jnp.asarray(x), seed=3)
    # non-trivial GroupNorm scale / bias
    p = jax.tree_util.tree_map_with_path(
        lambda k, v: v + 0.1 * jnp.arange(v.size).reshape(v.shape)
        if "GroupNorm" in str(k) else v, p)
    tm = carry(p, tlayers.ConvGN(16, 16, 3, 2)).to(getattr(torch, dtype))
    with torch.no_grad():
        out = tm(nchw(x))
    ref = japply(jm, p, jnp.asarray(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    close(out.permute(0, 2, 3, 1).numpy(), ref,
          1e-5 if dtype == "float32" else 1e-6)


@pytest.mark.parametrize("src,dst", [
    ((120, 188), (12, 12)), ((60, 94), (36, 36)), ((15, 24), (4, 4)),
    ((31, 47), (12, 12)), ((30, 47), (36, 36)), ((24, 32), (96, 128))])
def test_resize(src, dst):
    """bilinear: jax.image.resize antialiases when it shrinks (the SOLO
    grids) and is plain half-pixel bilinear when it grows."""
    rng = np.random.default_rng(src[0] + dst[1])
    x = rng.standard_normal((1,) + src + (3,)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1,) + dst + (3,), "bilinear")
    out = tlayers.resize(nchw(x), dst).permute(0, 2, 3, 1).numpy()
    close(out, ref, 1e-5)


def test_backbone_fpn():
    """C2..C5 and P2..P5 (nearest at half-pixel centres in the FPN) on
    an odd-sized input."""
    x = tlayers.normalize_image(texture(5, (75, 101))).numpy()
    xj = jnp.asarray(np.moveaxis(x, 1, -1))

    class BF(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            c = jlayers.Backbone()(x)
            return c, jlayers.FPN(64)(c)

    p = jinit(BF(), xj, seed=4)
    cj, pj = japply(BF(), p, xj)
    bb = carry({"params": p["params"]["Backbone_0"]}, tlayers.Backbone())
    fpn = carry({"params": p["params"]["FPN_0"]}, tlayers.FPN())
    with torch.no_grad():
        ct = bb(torch.from_numpy(x))
        pt = fpn(ct)
    for a, b in zip(ct + pt, list(cj) + list(pj)):
        close(a.permute(0, 2, 3, 1).numpy(), b)


def test_normalize_image():
    img = np.random.default_rng(6).integers(0, 256, HW).astype(np.uint8)
    ref = jlayers.normalize_image(img)
    out = tlayers.normalize_image(img).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- SOLOv2
def _solo_pair(seed=0, **hp):
    jm = jsolo.Solov2(**hp)
    img = jlayers.normalize_image(texture(seed))
    p = jinit(jm, img, seed=seed)
    tm = carry(p, tsolo.Solov2(**hp))
    return jm, p, tm, img


def test_solov2_raw_outputs():
    hp = dict(num_classes=8, grid_sizes=(12, 8, 6, 4))
    jm = jsolo.Solov2(**hp)
    img = jlayers.normalize_image(texture(0))
    p = shipped("solo")
    tm = carry(p, tsolo.Solov2(**hp))
    ref = japply(jm, p, img)
    with torch.no_grad():
        out = tm(nchw(img))
    close(out[0].numpy(), ref[0])
    close(out[1].numpy(), ref[1])
    close(out[2].permute(0, 2, 3, 1).numpy(), ref[2])


def _near(x, thresholds):
    x = np.asarray(x)
    return np.any([np.abs(x - t) < THRESH_TOL for t in thresholds], axis=0)


@pytest.mark.parametrize("score_thresh", [0.0, 0.3])
def test_solov2_decode(score_thresh):
    """The same raw head outputs through both decodes: scores, top-k
    order and labels exact (ties at score 0, left by the threshold, to
    the lower index), masks exact but for pixels within THRESH_TOL of
    0.5 (counted, at most 0.01% of the live masks' pixels)."""
    jm, p, _, img = _solo_pair(1)
    k, s, m = japply(jm, p, img)
    # spread the category logits so that some cells pass 0.3
    s = s + 4.6 * jnp.asarray(np.random.default_rng(1).uniform(
        0, 1.2, s.shape), jnp.float32)
    ref = jax.jit(lambda *a: jsolo.decode(*a, HW, score_thresh=score_thresh))(
        k, s, m)
    args = (torch.from_numpy(np.asarray(k)), torch.from_numpy(np.asarray(s)),
            nchw(m), HW)
    out = tsolo.decode(*args, score_thresh=score_thresh)
    prob = tsolo.decode_prob(*args, score_thresh=score_thresh)[0].numpy()
    rs = np.asarray(ref.scores)
    np.testing.assert_allclose(out.scores.numpy(), rs, atol=DEC_ATOL)
    assert not _near(rs, (0.05,)).any()
    np.testing.assert_array_equal(out.labels.numpy(),
                                  np.asarray(ref.labels))
    live = rs > 0
    assert live.sum() > 0
    diff = out.masks.numpy()[live] != np.asarray(ref.masks)[live]
    near = _near(prob[live], (0.5,))
    assert not (diff & ~near).any()
    assert near.sum() <= 1e-4 * near.size, near.sum()


def test_matrix_nms():
    rng = np.random.default_rng(7)
    masks = (rng.uniform(size=(24, 300)) < 0.3).astype(np.float32)
    masks[5] = masks[2]                      # a duplicate
    labels = rng.integers(0, 3, 24)
    scores = np.sort(rng.uniform(0.1, 1, 24))[::-1].copy()
    ref = jsolo.matrix_nms(jnp.asarray(masks), jnp.asarray(labels),
                           jnp.asarray(scores))
    out = tsolo.matrix_nms(torch.from_numpy(masks),
                           torch.from_numpy(labels),
                           torch.from_numpy(scores))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_top_k_ties():
    x = np.array([0.0, 0.5, 0.0, 0.5, 0.2, 0.0, 0.0, 0.9, 0.0], np.float32)
    v, i = jax.lax.top_k(jnp.asarray(x), 7)
    tv, ti = tsolo.top_k(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))


# ---------------------------------------------------------------- FCOS3D
def test_det3d_raw_and_decode():
    jm = jdet3d.FCOS3D(num_classes=6)
    img = jlayers.normalize_image(texture(2))
    p = shipped("det3d")
    tm = carry(p, tdet3d.FCOS3D(num_classes=6))
    ref = japply(jm, p, img)
    with torch.no_grad():
        out = tm(nchw(img))
    for lo, lr in zip(out, ref):
        for a, b in zip(lo, lr):
            close(a.permute(0, 2, 3, 1).numpy(), b)
    intr = (120.0, 118.0, 64.0, 47.5)
    lv = [tuple(torch.from_numpy(np.moveaxis(np.asarray(t), -1, 1).copy())
                for t in level) for level in ref]
    for thr in (0.0, 0.02):
        dr = jax.jit(lambda o: jdet3d.decode(o, jm.strides, intr,
                                             score_thresh=thr))(ref)
        do = tdet3d.decode(lv, tm.strides, intr, score_thresh=thr)
        np.testing.assert_array_equal(do.labels.numpy(),
                                      np.asarray(dr.labels))
        for a, b in zip(do[:1] + do[2:], dr[:1] + dr[2:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=DEC_ATOL)


def test_online_detector3d_boxes():
    intr = (120.0, 118.0, 64.0, 47.5)
    jd = jdet3d.OnlineDetector3D(HW, intr, score_thresh=0.0,
                                 **jpre.hyperparams("det3d"),
                                 params_path=jpre.weights_path("det3d"))
    td = tpre.load_online("det3d", HW, intr, device="cpu",
                          score_thresh=0.0)
    img = texture(3)
    bj, bt = jd(img), td(img)
    assert len(bj) == len(bt) > 0
    for a, b in zip(bt, bj):
        assert a.class_name == b.class_name
        assert a.score == pytest.approx(b.score, abs=1e-5)
        np.testing.assert_allclose(a.bottom_center, b.bottom_center,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a.dims, b.dims, rtol=1e-4)
        assert a.yaw == pytest.approx(b.yaw, abs=1e-4)


# ---------------------------------------------------------------- stereo
def test_correlation_volume():
    rng = np.random.default_rng(8)
    fl = rng.standard_normal((1, 6, 20, 32)).astype(np.float32)
    fr = rng.standard_normal((1, 6, 20, 32)).astype(np.float32)
    ref = jstereo.correlation_volume(jnp.asarray(fl), jnp.asarray(fr), 9)
    out = tstereo.correlation_volume(nchw(fl), nchw(fr), 9)  # [B,G,D,H,W]
    np.testing.assert_allclose(out.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(ref), atol=1e-6)


def test_stereo_net():
    rng = np.random.default_rng(9)
    left, right, _, _ = tdata.stereo_batch(rng, 1, HW, 32)
    jm = jstereo.StereoNet(max_disp=32)
    l, r = (jlayers.normalize_image(a[0]) for a in (left, right))
    p = shipped("stereo")
    tm = carry(p, tstereo.StereoNet(max_disp=32))
    with torch.no_grad():
        out = tm(nchw(l), nchw(r))
    close(out.numpy(), japply(jm, p, l, r))


def test_online_stereo_matcher():
    """The wrapper (max_disp 64, the shipped weights) against the JAX
    wrapper's computation (`normalize_image` + apply)."""
    rng = np.random.default_rng(10)
    left, right, _, _ = tdata.stereo_batch(rng, 1, HW, 32)
    jm = jstereo.StereoNet(max_disp=64)
    ref = japply(jm, shipped("stereo"), jlayers.normalize_image(left[0]),
                   jlayers.normalize_image(right[0]))[0]
    out = tpre.load_online("stereo", HW, device="cpu", max_disp=64)(
        left[0], right[0])
    assert isinstance(out, np.ndarray) and out.shape == HW
    close(out, ref)


# ---------------------------------------------------------------- ReID
def test_reid_net():
    rng = np.random.default_rng(14)
    im, _ = tdata.reid_batch(rng, num_ids=4, views=4)
    x = (im / 255.0 - 0.45) / 0.225
    jm = jreid.ReidNet()
    p = shipped("reid")
    tm = carry(p, treid.ReidNet())
    with torch.no_grad():
        out = tm(nchw(x.astype(np.float32)))
    close(out.numpy(), japply(jm, p, jnp.asarray(x)))


def test_reid_extractor_crops():
    """Host crops with clamping (boxes past the borders, degenerate)."""
    img = texture(15)
    boxes = np.array([[10, 5, 40, 70], [-5, -8, 20, 30], [100, 80, 140, 99],
                      [50, 50, 50, 50], [3.7, 2.2, 9.9, 60.5]])
    jd = jreid.ReidExtractor(max_boxes=4,
                             params_path=jpre.weights_path("reid"))
    td = tpre.load_online("reid", None, device="cpu", max_boxes=4)
    ref = jd(img, boxes)
    out = td(img, boxes)
    assert out.shape == ref.shape == (4, 128)
    np.testing.assert_allclose(out, ref, atol=1e-5)


# ------------------------------------------------- weights and generators
@pytest.mark.parametrize("task", ["solo", "det3d", "stereo", "flow",
                                  "reid"])
def test_shipped_checkpoint_loads(task):
    """Every leaf of the port's loaded module equals the JAX package's
    loaded tree; the manifest and paths agree."""
    assert tpre.manifest() == jpre.manifest()
    assert tpre.hyperparams(task) == jpre.hyperparams(task)
    assert open(tpre.weights_path(task), "rb").read() == \
        open(jpre.weights_path(task), "rb").read()
    w = tpre.load_online(task, HW, (100.0, 100.0, 64.0, 48.0),
                         device="cpu")
    data = np.load(jpre.weights_path(task))
    state = w.model.state_dict()
    for k in data.files:
        name = convert._flax_key(k)
        np.testing.assert_array_equal(
            state[name].numpy(),
            convert._flax_array(data[k].astype(np.float32)).numpy())
    assert len(data.files) == len(state)


def test_checkpoint_shape_mismatch_raises():
    """solo.npz (8 classes) into the default 80-class detector: JAX
    builds it and raises at the first call; the port raises when it
    loads."""
    path = jpre.weights_path("solo")
    jd = jsolo.OnlineDetector2D((64, 96), params_path=path)
    with pytest.raises(Exception, match="cate_out"):
        jd(np.zeros((64, 96), np.float32))
    with pytest.raises(ValueError, match="cate_out"):
        tsolo.OnlineDetector2D((64, 96), params_path=path, device="cpu")


@pytest.mark.parametrize("name", ["stereo", "flow", "reid"])
def test_generators_equal(name):
    args = dict(stereo=(2, (48, 64), 16), flow=(2, (48, 64)),
                reid=(3, 2))[name]
    fn = f"{name}_batch"
    a = getattr(jdata, fn)(np.random.default_rng(5), *args)
    b = getattr(tdata, fn)(np.random.default_rng(5), *args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
