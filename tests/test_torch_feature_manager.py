"""Port parity: the estimator's host landmark bookkeeping. Fed the same
frames, the port's FeatureManager makes the same keyframe decisions,
slots and depths as the JAX one through add/solve/outlier/slide steps,
and emits the same observation rows in the same order (slot-major,
frame, left then right: the solver's segment sums follow it), both as
the packed numpy tables and as the ProjObs table."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.estimator.feature_manager import \
    FeatureManager as JFeatureManager
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch.estimator.feature_manager import \
    FeatureManager as TFeatureManager

torch.set_num_threads(1)   # the xdist workers share the cores

STATE = ("active", "feature_id", "start_frame", "has_obs", "has_right",
         "pt", "pt_right", "vel", "vel_right", "inv_depth", "depth_valid")


def _same_state(jfm, tfm):
    for name in STATE:
        np.testing.assert_array_equal(getattr(tfm, name),
                                      getattr(jfm, name), err_msg=name)


def _same_tables(jfm, tfm):
    for a, b in zip(jfm.build_obs_packed(), tfm.build_obs_packed()):
        np.testing.assert_array_equal(b, a)
    # the ProjObs table: equal on its valid rows (the padding rows are
    # masked out of every sum; the port pads them as the packed path)
    oj, mj = jfm.build_obs_table()
    ot, mt = tfm.build_obs_table(torch.float64, "cpu")
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    v = np.asarray(oj.valid)
    np.testing.assert_array_equal(ot.valid.numpy(), v)
    for name in oj._fields:
        np.testing.assert_array_equal(getattr(ot, name).numpy()[v],
                                      np.asarray(getattr(oj, name))[v],
                                      err_msg=name)


@pytest.mark.parametrize("margin_old", [True, False])
def test_bookkeeping_and_obs_tables_match(margin_old):
    seq = jsim.generate_sequence(num_frames=7, imu_hz=200.0,
                                 num_landmarks=120, seed=1)
    frames = jfs.make_frames(seq, pixel_noise=0.5, max_feats=60)
    F = 5
    kw = dict(num_frames=F, capacity=96, obs_capacity=1024)
    jfm, tfm = JFeatureManager(**kw), TFeatureManager(**kw)
    rng = np.random.default_rng(0)
    for t, (frame, _) in enumerate(frames):
        k = min(t, F - 1)
        assert tfm.add_features(k, frame.features) == \
            jfm.add_features(k, frame.features)
        # depths for the new slots, then a solve's write-back
        new = jfm.active & ~jfm.depth_valid
        d = rng.uniform(0.05, 0.3, size=new.sum())
        for fm in (jfm, tfm):
            fm.inv_depth[new] = d
            fm.depth_valid[new] = True
        _same_state(jfm, tfm)
        _same_tables(jfm, tfm)
        solved = jfm.inv_depth * rng.uniform(0.9, 1.1, size=96)
        solved[::17] = -1e-3          # culled: negative depth
        bad = rng.uniform(size=96) < 0.05
        for fm in (jfm, tfm):
            fm.set_depths(solved.copy())
            fm.remove_outliers(bad)
        _same_state(jfm, tfm)
        if t >= F - 1:
            if margin_old:
                fn = lambda slots: np.where(slots % 5 == 0, np.nan,
                                            0.1 + 0.001 * slots)
                jfm.slide_old(fn)
                tfm.slide_old(fn)
            else:
                jfm.slide_new()
                tfm.slide_new()
            _same_state(jfm, tfm)
            _same_tables(jfm, tfm)
    assert tfm.build_obs_packed()[2].sum() > 50


@pytest.mark.parametrize("margin_old", [True, False])
def test_steady_state_hooks_match(margin_old):
    """The hooks of the megastep and the pipelined steady state: the
    lifecycle deltas (`last_new_slots`, `last_slide_dead`), the rows
    for extra slots (`build_obs_packed(extra_mask)`, `obs_emit_mask`)
    and the write-back of chosen slots (`set_depths(valid_update)`)."""
    seq = jsim.generate_sequence(num_frames=8, imu_hz=200.0,
                                 num_landmarks=120, seed=5)
    frames = jfs.make_frames(seq, pixel_noise=0.5, max_feats=60)
    F, L = 5, 96
    kw = dict(num_frames=F, capacity=L, obs_capacity=1024)
    jfm, tfm = JFeatureManager(**kw), TFeatureManager(**kw)
    rng = np.random.default_rng(1)
    dead_seen = 0
    for t, (frame, _) in enumerate(frames):
        k = min(t, F - 1)
        # broken tracks, so that slides leave slots without observations
        feats = {i: f for i, f in frame.features.items()
                 if rng.uniform() < 0.7}
        jfm.add_features(k, feats)
        tfm.add_features(k, feats)
        np.testing.assert_array_equal(tfm.last_new_slots,
                                      jfm.last_new_slots)
        # the candidates: half of the slots still without a depth
        extra = jfm.active & ~jfm.depth_valid & (rng.uniform(size=L) < 0.5)
        np.testing.assert_array_equal(tfm.obs_emit_mask(extra),
                                      jfm.obs_emit_mask(extra))
        np.testing.assert_array_equal(tfm.obs_emit_mask(),
                                      jfm.obs_emit_mask())
        for a, b in zip(jfm.build_obs_packed(extra_mask=extra),
                        tfm.build_obs_packed(extra_mask=extra)):
            np.testing.assert_array_equal(b, a)
        solved = rng.uniform(0.05, 0.3, size=L)
        solved[::13] = -1e-3          # culled: negative depth
        update = jfm.solvable_mask() | extra
        for fm in (jfm, tfm):
            fm.set_depths(solved.copy(), valid_update=update.copy())
            fm.depth_valid[extra] = True
        _same_state(jfm, tfm)
        if t >= F - 1:
            if margin_old:
                fn = lambda slots: 0.1 + 0.001 * slots
                jfm.slide_old(fn)
                tfm.slide_old(fn)
            else:
                jfm.slide_new()
                tfm.slide_new()
            np.testing.assert_array_equal(tfm.last_slide_dead,
                                          jfm.last_slide_dead)
            dead_seen += int(tfm.last_slide_dead.sum())
            _same_state(jfm, tfm)
    assert dead_seen > 0
