"""Port parity for DYNAMIC with every perception net online: the System
with `det2d_online`, `det3d_online`, `stereo_online`, `use_dense_flow`
and `use_reid` on (stereo + IMU, the 0.5-scale rig of
tests/test_system.py, a window of 5), against the JAX System on the
same 3 rendered frames of a moving box, with no offline artifact in the
frames: each side's nets make the segmentation, 3D boxes, disparity,
flow and ReID embeddings.

The Systems build their own nets (float32): SOLOv2 and FCOS3D at the
System's default shapes, the JAX side's seeded parameters carried into
the port's (`convert.flax_params`; score threshold 0, as the JAX
package's own online smoke test runs its untrained detector); the
stereo net, RAFT and ReID from the shipped checkpoints, which both
Systems load through `VioConfig.*_weights`. The trackers run in float64
(tests/test_torch_dynamic_system.py says why), RANSAC-F off.

The untrained detector's 128 candidates score within ~1e-3 of each
other, and the port's raw head outputs differ from JAX's by ~1e-4
relative on rendered frames (flax's GroupNorm takes E[x^2] - E[x]^2 in
float32, which cancels on the frames' flat regions, in either
package's summation order), so near-equal scores can trade places and
drag the masks and MOT's ids with them. The port's SOLOv2 therefore
runs in lockstep: in the port System's perception stage it segments the
frame, its result is held to the JAX net's (each of its detections
matched to one of JAX's of the same label, score within 5e-3 relative,
mask equal but for pixels whose probability lies within 1e-3 of 0.5,
those excluded and counted: at most 0.01% of the pixels; a matched pair
in another order is counted as a swap), and the JAX result goes on, so
that the rest of the two Systems see the same instances.

Per frame, beside that: the 3D boxes' classes exactly, their numbers
1e-4; the disparity and the flow 0.05 px (the same GroupNorm
cancellation, amplified by the soft-argmin over 32 candidates and by
RAFT's 8 updates; tests/test_torch_models.py and
tests/test_torch_dense_flow.py hold the nets to 1e-4 of scale and 1e-3
px on generator images); the background tracker's slots and ids
exactly, points 1e-3 px; the instance tracker's ids; the ego positions
1e-3 m; every net called on every frame where the JAX System calls it.
The pipelined System (port only, the same carried SOLOv2 and FCOS3D
parameters) runs the same frames with every net online: each net
called as on the sequential path, an output for every frame once
drained, finite positions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.models import pretrained as jpre
from dynamic_vins_tpu.sim import dynamic_scene as jdyn
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import render, synthetic as sim
from dynamic_vins_tpu.system import FrameInput as JFrameInput
from dynamic_vins_tpu.system import System as JSystem
from dynamic_vins_tpu.utils import prefetch
from dynamic_vins_tpu.utils.config import SlamMode as JSlamMode
from dynamic_vins_tpu_torch import convert
from dynamic_vins_tpu_torch.io import perception
from dynamic_vins_tpu_torch.models import layers as tlayers
from dynamic_vins_tpu_torch.models import solov2 as tsolo
from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
from dynamic_vins_tpu_torch.system import System as TSystem
from dynamic_vins_tpu_torch.utils.config import SlamMode as TSlamMode
from test_torch_dynamic_system import _float64_trackers, _landed
from test_torch_models import flat, jit_flax_init  # noqa: F401 (autouse)
from test_torch_system import _configs

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 3
POS_ATOL = 1e-3          # m
PX_ATOL = 1e-3           # px: tracked points
DISP_ATOL = 0.05         # px
FLOW_ATOL = 0.05         # px
NUM_ATOL = 1e-4          # box numbers
SCORE_RTOL = 5e-3
THRESH_TOL = 1e-3        # mask probabilities this close to 0.5
SWITCHES = ("det2d_online", "det3d_online", "stereo_online",
            "use_dense_flow", "use_reid")


@pytest.fixture(scope="module")
def scene():
    rig = render.small_rig(0.5, jnp.float64)
    seq = sim.generate_sequence(num_frames=FRAMES, imu_hz=200.0,
                                acc_noise=0.02, gyr_noise=0.002,
                                num_landmarks=220, seed=5)._replace(rig=rig)
    frames, _ = jdyn.make_dynamic_scene(seq, num_objects=1, seed=5)
    return rig, seq, frames


def _systems(tmp_path, rig, pipelined):
    jcfg, tcfg = _configs(rig)
    for cfg, mode in ((jcfg, JSlamMode.DYNAMIC), (tcfg, TSlamMode.DYNAMIC)):
        cfg.slam = mode
        cfg.window_size = 5
        cfg.max_cnt = 100
        cfg.mot_n_init = 2
        cfg.pipelined = pipelined
        cfg.det2d_score_thresh = 0.0
        for name in SWITCHES:
            setattr(cfg, name, True)
        for task, name in (("stereo", "stereo_weights"),
                           ("flow", "flow_weights"),
                           ("reid", "reid_weights")):
            setattr(cfg, name, jpre.weights_path(task))
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    assert all(x is not None for x in (ts.det2d, ts.det3d, ts.stereo_net,
                                       ts.flow_net, ts._reid))
    assert ts.mot.embed_fn is not None
    _float64_trackers(js, ts)
    for j, t in ((js.det2d, ts.det2d), (js.det3d, ts.det3d)):
        t.model.load_state_dict(convert.flax_params(flat(j.params),
                                                    t.model))
    js.tracker.cfg.use_ransac_f = ts.tracker.cfg.use_ransac_f = False
    return js, ts


def _inputs(seq, frames, FI):
    frames_imu = jfs.make_frames(seq)
    return [FI(float(seq.frame_times[k]), df.img_left, df.img_right,
               imu=frames_imu[k][1]) for k, df in enumerate(frames)]


class Lockstep:
    """The port's SOLOv2 inside the port System: segments the frame,
    records its result beside the JAX net's, returns the JAX result."""

    def __init__(self, port, ref):
        self.port, self.ref, self.pairs = port, ref, []
        self.image_hw = port.image_hw

    def __call__(self, img):
        out, ref = self.port(img), self.ref(img)
        with torch.no_grad():
            k, s, m = self.port.model(tlayers.normalize_image(img))
            prob = tsolo.decode_prob(k, s, m, self.image_hw,
                                     score_thresh=0.0)[0].numpy()
        self.pairs.append((out, ref, prob[:len(out.masks)]))
        return ref


def _same_segmentation(out, ref, prob):
    """Each port detection matched to one JAX detection; returns the
    (excluded pixels, swaps)."""
    assert len(out.masks) == len(ref.masks) > 0
    free = set(range(len(ref.masks)))
    excluded = swaps = 0
    for i in range(len(out.masks)):
        near = np.abs(prob[i] - 0.5) < THRESH_TOL
        match = None
        for j in sorted(free, key=lambda j: abs(j - i)):
            diff = out.masks[i] != ref.masks[j]
            if (out.labels[i] == ref.labels[j]
                    and abs(out.scores[i] / ref.scores[j] - 1) < SCORE_RTOL
                    and not (diff & ~near).any()):
                match = j
                break
        assert match is not None, i
        free.remove(match)
        excluded += int((diff & near).sum())
        swaps += match != i
    return excluded, swaps


def _same_perception(fj, ft, js, ts):
    np.testing.assert_array_equal(ft.seg.masks, fj.seg.masks)
    assert [b.class_name for b in ft.boxes3d] == \
        [b.class_name for b in fj.boxes3d]
    for a, b in zip(ft.boxes3d, fj.boxes3d):
        for key in ("score", "bottom_center", "dims", "yaw"):
            np.testing.assert_allclose(getattr(a, key), getattr(b, key),
                                       rtol=0, atol=NUM_ATOL, err_msg=key)
    np.testing.assert_allclose(ft.disparity, fj.disparity, rtol=0,
                               atol=DISP_ATOL)
    assert (ts.last_flow is None) == (js.last_flow is None)
    if js.last_flow is not None:
        np.testing.assert_allclose(ts.last_flow.numpy(), js.last_flow,
                                   rtol=0, atol=FLOW_ATOL)


def test_online_dynamic_system_matches_jax(tmp_path, monkeypatch, scene):
    monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
    rig, seq, frames = scene
    js, ts = _systems(tmp_path, rig, pipelined=False)
    ts.det2d = Lockstep(ts.det2d, js.det2d)
    v0 = np.asarray(sim.state_at(seq.frame_times[0])[2])
    for s in (js, ts):
        s.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                     np.asarray(seq.gt_q[0]), v0)
    pj, pt = [], []
    n_seg = 0
    for fj, ft in zip(_inputs(seq, frames, JFrameInput),
                      _inputs(seq, frames, TFrameInput)):
        pj.append(js.process(fj).p)
        pt.append(ts.process(ft).p)
        _same_perception(fj, ft, js, ts)
        n_seg += len(ft.seg.masks)
        np.testing.assert_array_equal(ts.tracker.valid, js.tracker.valid)
        np.testing.assert_array_equal(ts.tracker.ids, js.tracker.ids)
        np.testing.assert_allclose(ts.tracker.pts[ts.tracker.valid],
                                   js.tracker.pts[js.tracker.valid],
                                   rtol=0, atol=PX_ATOL)
        np.testing.assert_array_equal(ts.inst_tracker.ids,
                                      js.inst_tracker.ids)
    assert n_seg > 0 and ts.last_flow is not None
    assert len(ts.det2d.pairs) == FRAMES
    dynamic = sum(any(int(l) in perception.COCO_DYNAMIC_IDS
                      for l in ref.labels) for _, ref, _ in ts.det2d.pairs)
    assert ts.timer.counts["pe.reid"] == dynamic > 0
    excluded = swaps = 0
    for out, ref, prob in ts.det2d.pairs:
        e, w = _same_segmentation(out, ref, prob)
        excluded, swaps = excluded + e, swaps + w
    assert excluded <= 1e-4 * FRAMES * len(out.masks) * prob[0].size, \
        excluded
    assert swaps <= 4, swaps
    timer = ts.timer.summary()
    for stage in ("pe.det2d", "pe.det3d", "pe.stereo", "pe.flow",
                  "pe.reid"):
        assert stage in timer, stage
    assert ts.timer.counts["pe.flow"] == FRAMES
    np.testing.assert_allclose(np.stack(pt), np.stack(pj), rtol=0,
                               atol=POS_ATOL)
    js.close()
    ts.close()


def test_online_dynamic_system_pipelined(tmp_path, scene):
    rig, seq, frames = scene
    js, ts = _systems(tmp_path, rig, pipelined=True)
    js.close()
    v0 = np.asarray(sim.state_at(seq.frame_times[0])[2])
    ts.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                  np.asarray(seq.gt_q[0]), v0)
    inputs = _inputs(seq, frames, TFrameInput)
    outs = [ts.process(fi) for fi in inputs]
    outs = [o for o in outs if o is not None] + ts.drain()
    assert [o.timestamp for o in outs] == \
        [float(t) for t in seq.frame_times[:FRAMES]]
    assert np.isfinite(np.stack([o.p for o in outs])).all()
    counts = ts.timer.counts
    assert counts["pe.det2d"] == counts["pe.det3d"] == \
        counts["pe.stereo"] == counts["pe.flow"] == FRAMES
    # MOT embeds the frames that hold a dynamic-class detection
    dynamic = sum(any(int(l) in perception.COCO_DYNAMIC_IDS
                      for l in fi.seg.labels) for fi in inputs)
    assert counts["pe.reid"] == dynamic > 0
    ts.close()
