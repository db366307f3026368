"""Port parity: the feature stream's record/replay format. The same
frames (points, lines, IMU) serialize to byte-equal lines in both
packages; a file either package writes replays in the other to equal
frames; and the port's record -> replay gives an identical backend run
(float64 on the CPU, exact), as tests/test_feature_serialization.py asks
of the JAX package."""

import numpy as np
import torch

from dynamic_vins_tpu.estimator.estimator import \
    FrameFeatures as JFrameFeatures
from dynamic_vins_tpu.io import feature_serialization as jfs
from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                        EstimatorConfig,
                                                        FrameFeatures)
from dynamic_vins_tpu_torch.io import feature_serialization as tfs
from dynamic_vins_tpu_torch.sim import frontend_sim
from dynamic_vins_tpu_torch.sim import synthetic as sim

torch.set_num_threads(1)   # the xdist workers share the cores


def _frames(n=4, seed=0):
    """[(features, lines, imu)] with stereo and mono points, lines with
    and without a right observation, frames with and without IMU."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        feats = {}
        for fid in rng.choice(1000, size=12, replace=False):
            pl = np.array([*rng.normal(size=2), 1.0])
            vl = np.array([*rng.normal(size=2) * 0.1, 0.0])
            if rng.random() < 0.6:
                feats[int(fid)] = (pl, vl, np.array([*rng.normal(size=2),
                                                     1.0]), np.zeros(3))
            else:
                feats[int(fid)] = (pl, vl, None, None)
        lines = None
        if k % 2:
            lines = {}
            for lid in range(3):
                s, e = rng.normal(size=3), rng.normal(size=3)
                right = (rng.normal(size=3), rng.normal(size=3)) \
                    if lid != 1 else (None, None)
                lines[lid + 10 * k] = (s, e) + right
        imu = None
        if k > 0:
            m = int(rng.integers(1, 6))
            imu = (rng.normal(size=(m + 1, 3)), rng.normal(size=(m + 1, 3)),
                   np.full(m, 0.005))
        out.append((0.1 * k + 1e-7 * rng.random(), feats, lines, imu))
    return out


def _assert_same_frame(a, ia, b, ib):
    assert a.timestamp == b.timestamp
    assert a.features.keys() == b.features.keys()
    for fid in a.features:
        for x, y in zip(a.features[fid], b.features[fid]):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert (a.lines is None) == (b.lines is None)
    if a.lines is not None:
        assert a.lines.keys() == b.lines.keys()
        for lid in a.lines:
            for x, y in zip(a.lines[lid], b.lines[lid]):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(y, x)
    assert (ia is None) == (ib is None)
    if ia is not None:
        for x, y in zip(ia, ib):
            np.testing.assert_array_equal(y, x)


def test_lines_byte_equal():
    for t, feats, lines, imu in _frames():
        j = jfs.serialize_frame(JFrameFeatures(t, feats, lines), imu)
        p = tfs.serialize_frame(FrameFeatures(t, feats, lines), imu)
        assert p == j


def test_files_cross_replay(tmp_path):
    frames = _frames(seed=1)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    with jfs.FeatureRecorder(jpath) as rec:
        for t, feats, lines, imu in frames:
            rec.record(JFrameFeatures(t, feats, lines), imu)
    with tfs.FeatureRecorder(tpath) as rec:
        for t, feats, lines, imu in frames:
            rec.record(FrameFeatures(t, feats, lines), imu)
    with open(jpath) as a, open(tpath) as b:
        assert a.read() == b.read()
    port_of_jax = list(tfs.replay(jpath))
    jax_of_port = list(jfs.replay(tpath))
    assert len(port_of_jax) == len(jax_of_port) == len(frames)
    for (t, feats, lines, imu), (fp, ip), (fj, ij) in zip(
            frames, port_of_jax, jax_of_port):
        assert isinstance(fp, FrameFeatures)
        src = FrameFeatures(t, feats, lines)
        _assert_same_frame(src, imu, fp, ip)
        _assert_same_frame(src, imu, fj, ij)


def test_record_replay_identical_backend(tmp_path):
    """tests/test_feature_serialization.py's protocol on the port, its
    capacities cut to the scene's ~40 features a frame (the padded rows
    set the CPU's time, not the result's kind)."""
    seq = sim.generate_sequence(num_frames=10, imu_hz=200.0,
                                num_landmarks=150, seed=2)
    frames = frontend_sim.make_frames(seq, pixel_noise=0.4, seed=2)
    rig = seq.rig
    p_bc = np.stack([rig.p_bc.numpy(), rig.right_extrinsics()[0].numpy()])
    q_bc = np.stack([rig.q_bc.numpy(), rig.right_extrinsics()[1].numpy()])
    path = str(tmp_path / "feats.jsonl")

    def fresh():
        est = Estimator(EstimatorConfig(num_frames=6, lm_capacity=128,
                                        obs_capacity=1024,
                                        dtype=torch.float64),
                        p_bc, q_bc, device="cpu")
        est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                             sim.state_at(seq.frame_times[0])[2].numpy())
        return est

    est1 = fresh()
    outs1 = []
    with tfs.FeatureRecorder(path) as rec:
        for frame, imu in frames:
            rec.record(frame, imu)
            outs1.append(est1.process_frame(frame, imu))
    est2 = fresh()
    outs2 = [est2.process_frame(f, i) for f, i in tfs.replay(path)]
    assert len(outs1) == len(outs2) == 10
    assert sum(o is not None for o in outs1) >= 5
    for a, b in zip(outs1, outs2):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(b.p, a.p)
            np.testing.assert_array_equal(b.q, a.q)
