"""Port parity for dense-flow tracking (`use_dense_flow`): RAFT's pieces
and net, `lk.track_by_dense_flow`, the background tracker's flow
variant and the System with an offline flow field, against the JAX
package on the same inputs (numpy, seeded) with the same parameters.

Tolerances: `lookup` 1e-6; the correlation volume 1e-5; RAFT's
full-resolution flow 1e-3 px (float32, 8 recurrent updates, the shipped
weights); `track_by_dense_flow` in float64 exact, in float32 1e-5 px
with equal `ok` (a point within 1e-4 px of a border threshold would be
excluded and counted: none is); the trackers (float64, RANSAC-F off)
equal slots, ids and track counts, points 1e-6 px, normalized
coordinates 1e-7 (they cross in a float32 pack); the Systems the
same, and the features moved by the field's 5 px (the JAX package's
own test) within 0.5 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.frontend import lk as jlk
from dynamic_vins_tpu.frontend.tracker import FeatureTracker as JTracker
from dynamic_vins_tpu.frontend.tracker import TrackerConfig as JConfig
from dynamic_vins_tpu.geometry.camera import PinholeIntrinsics as JIntr
from dynamic_vins_tpu.models import pretrained as jpre
from dynamic_vins_tpu.models import raft as jraft
from dynamic_vins_tpu.sim import render
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu_torch.frontend import lk as tlk
from dynamic_vins_tpu_torch.frontend.tracker import FeatureTracker as TTracker
from dynamic_vins_tpu_torch.frontend.tracker import TrackerConfig as TConfig
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics as TIntr
from dynamic_vins_tpu_torch.models import pretrained as tpre
from dynamic_vins_tpu_torch.models import raft as traft
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.training import data as tdata
from test_torch_models import jit_flax_init  # noqa: F401 (autouse)
from test_torch_system import _configs
from test_torch_tracker import _frames

torch.set_num_threads(1)   # the xdist workers share the cores

HW = (96, 128)
FLOW_ATOL = 1e-3         # px, RAFT
PX_ATOL = 1e-6           # px, float64 trackers


def smooth_flow(seed, hw, shift=(4.0, -2.0), amp=3.0):
    rng = np.random.default_rng(seed)
    f = np.stack([(tdata._smooth_noise(rng, *hw) - 0.5) * 2 * amp + s
                  for s in shift], -1)
    return f.astype(np.float32)


# ---------------------------------------------------------------- RAFT
def test_lookup():
    rng = np.random.default_rng(11)
    corr = rng.standard_normal((30, 5, 6)).astype(np.float32)
    # coords inside, on and past every border
    coords = np.stack([rng.uniform(-4, 10, 30), rng.uniform(-4, 9, 30)],
                      -1).astype(np.float32)
    coords[:4] = [[0, 0], [5, 4], [4.999, 3.5], [-10, 20]]
    ref = jraft.lookup(jnp.asarray(corr), jnp.asarray(coords), 3)
    out = traft.lookup(torch.from_numpy(corr), torch.from_numpy(coords), 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_all_pairs_correlation():
    rng = np.random.default_rng(12)
    f1 = rng.standard_normal((7, 9, 16)).astype(np.float32)
    f2 = rng.standard_normal((7, 9, 16)).astype(np.float32)
    ref = jraft.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    out = traft.all_pairs_correlation(
        torch.from_numpy(np.moveaxis(f1, -1, 0).copy()),
        torch.from_numpy(np.moveaxis(f2, -1, 0).copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_raft_flow():
    """The online wrappers with the shipped weights on a generator pair;
    the port's field is a tensor (it stays on the device)."""
    rng = np.random.default_rng(13)
    img1, img2, _, _ = tdata.flow_batch(rng, 1, HW)
    jd = jraft.OnlineFlowEstimator(HW, params_path=jpre.weights_path("flow"))
    td = tpre.load_online("flow", HW, device="cpu")
    ref = jd(img1[0], img2[0])
    out = td(img1[0], img2[0])
    assert isinstance(out, torch.Tensor) and out.shape == HW + (2,)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLOW_ATOL)


# ------------------------------------------------------- flow tracking
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("back", [False, True])
def test_track_by_dense_flow(dtype, back):
    H, W = 60, 80
    rng = np.random.default_rng(20 + back)
    flow = smooth_flow(1, (H, W)).astype(dtype)
    flow_back = -smooth_flow(1, (H, W)).astype(dtype) \
        + rng.normal(scale=0.8, size=(H, W, 2)).astype(dtype)
    pts = np.stack([rng.uniform(-2, W + 2, 200), rng.uniform(-2, H + 2,
                                                             200)], -1)
    pts[:6] = [[0, 0], [W - 1, H - 1], [3, 3], [W - 4, 10], [40, -1],
               [79.5, 59.5]]
    pts = pts.astype(dtype)
    valid = rng.uniform(size=200) < 0.8
    kw = dict(fb_thresh=1.5, border=3)
    jb = jnp.asarray(flow_back) if back else None
    tb = torch.from_numpy(flow_back) if back else None
    pj, okj = jlk.track_by_dense_flow(jnp.asarray(flow), jnp.asarray(pts),
                                      jnp.asarray(valid), jb, **kw)
    pt, okt = tlk.track_by_dense_flow(torch.from_numpy(flow),
                                      torch.from_numpy(pts),
                                      torch.from_numpy(valid), tb, **kw)
    pj, okj = np.asarray(pj), np.asarray(okj)
    atol = 0.0 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=atol)
    near = (np.abs(pj[:, 0] - 3) < 1e-4) | (np.abs(pj[:, 0] - (W - 3)) < 1e-4) \
        | (np.abs(pj[:, 1] - 3) < 1e-4) | (np.abs(pj[:, 1] - (H - 3)) < 1e-4)
    assert near.sum() == 0
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert 0 < okj.sum() < valid.sum()


def _trackers(rig):
    intr = [float(v) for v in (rig.intr.fx, rig.intr.fy, rig.intr.cx,
                               rig.intr.cy)]
    jt = JTracker(JConfig(max_cnt=80, min_dist=10, stereo=True,
                          dtype=jnp.float64),
                  JIntr.make(*intr, dtype=jnp.float64))
    tt = TTracker(TConfig(max_cnt=80, min_dist=10, stereo=True,
                          dtype=torch.float64),
                  TIntr.make(*intr), device="cpu")
    jt.cfg.use_ransac_f = tt.cfg.use_ransac_f = False
    return jt, tt


def test_tracker_follows_the_flow_field():
    """The fused step's flow variant: frame 0 ignores the field (no
    previous frame), frames 1-3 sample it; the stereo track stays LK."""
    rig, seq, frames = _frames(4)
    jt, tt = _trackers(rig)
    for k, (il, ir) in enumerate(frames):
        flow = smooth_flow(30 + k, il.shape, shift=(1.5, 0.5), amp=1.0)
        t = float(seq.frame_times[k])
        fj = jt.track(il, t, img_right=ir, flow=flow)
        ft = tt.track(il, t, img_right=ir, flow=torch.from_numpy(flow))
        np.testing.assert_array_equal(tt.valid, jt.valid)
        np.testing.assert_array_equal(tt.ids, jt.ids)
        np.testing.assert_array_equal(tt.track_cnt, jt.track_cnt)
        np.testing.assert_allclose(tt.pts[tt.valid], jt.pts[jt.valid],
                                   rtol=0, atol=PX_ATOL)
        assert sorted(ft.features) == sorted(fj.features)
        for fid, (pl, _, pr, _) in fj.features.items():
            tl, _, tr, _ = ft.features[fid]
            # the packed result is float32: 1e-7 ~ a few of its ulps
            np.testing.assert_allclose(tl, pl, rtol=0, atol=1e-7)
            assert (tr is None) == (pr is None)
    assert (tt.track_cnt > 1).sum() > 20


@pytest.mark.parametrize("pipelined", [False, True])
def test_system_dense_flow_tracking(tmp_path, pipelined):
    """tests/test_system.py's scenario on both Systems: an offline flow
    field of 5 px carries the background features (RAW, 0.5-scale rig,
    no IMU, no right image)."""
    rig = render.small_rig(0.5, jnp.float64)
    jcfg, tcfg = _configs(rig)
    jcfg.pipelined = tcfg.pipelined = pipelined
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    rng = np.random.default_rng(3)
    H, W = rig.height, rig.width
    img0 = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    dx = 5.0
    img1 = np.roll(img0, int(dx), axis=1)
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = dx
    snaps = []
    for s, FI in ((js, JFrameInput), (ts, TFrameInput)):
        s.process(FI(0.0, img0, None))
        if pipelined:
            s._finish_oldest_pending()
        snap = (s.tracker.pts.copy(), s.tracker.ids.copy(),
                s.tracker.valid.copy())
        s.process(FI(0.1, img1, None, flow=flow))
        if pipelined:
            s._finish_oldest_pending()
        snaps.append(snap + (s.tracker.pts.copy(), s.tracker.ids.copy(),
                             s.tracker.valid.copy()))
        assert s.last_flow is flow
    (p0j, i0j, v0j, pj, ij, vj), (p0t, i0t, v0t, pt, it, vt) = snaps
    np.testing.assert_array_equal(v0t, v0j)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(pt[vt], pj[vj], rtol=0, atol=1e-4)
    common = v0t & vt & (it == i0t)
    assert common.sum() >= 20
    np.testing.assert_allclose(pt[common, 0] - p0t[common, 0], dx,
                               atol=0.5)
    js.close()
    ts.close()
