"""Port parity: the synthetic BA problems (`sim/ba_problems.build`,
`perturb_state`) and the synthetic object frames
(`sim/objects.make_object_frames`) against the JAX package's, for the
same arguments, in float64: every field to 1e-10, the integer fields
and the feature sets equal."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.sim import ba_problems as jba
from dynamic_vins_tpu.sim import objects as jobj
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch.sim import ba_problems as tba
from dynamic_vins_tpu_torch.sim import objects as tobj
from dynamic_vins_tpu_torch.sim import synthetic as tsim

torch.set_num_threads(1)   # the xdist workers share the cores

ATOL = 1e-10


def _flat(t, prefix=""):
    """{dotted name: numpy array} of a (nested) NamedTuple; fields that
    are None (the JAX problem's line rows, which the port has not) are
    left out."""
    if hasattr(t, "_asdict"):
        out = {}
        for k, v in t._asdict().items():
            if v is not None:
                out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix.rstrip("."): np.asarray(t)}


def _assert_same(j, t):
    fj, ft = _flat(j), _flat(t)
    assert fj.keys() == ft.keys()
    for k in fj:
        a, b = fj[k], ft[k]
        assert a.shape == b.shape, k
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("stereo,seed", [(True, 0), (True, 3), (False, 0),
                                         (False, 3)])
def test_build_and_perturb_match(stereo, seed):
    kw = dict(num_frames=5, num_landmarks=80, obs_capacity=2048,
              lm_capacity=96, pixel_noise=0.5, seed=seed, stereo=stereo)
    j = jba.build(**kw)
    t = tba.build(**kw)
    assert int(np.asarray(j.problem.obs.valid).sum()) > 40
    _assert_same(j.gt_state, t.gt_state)
    _assert_same(j.gt_inv_depth, t.gt_inv_depth)
    _assert_same(j.problem, t.problem)
    _assert_same(jba.perturb_state(j.gt_state, seed=seed + 7),
                 tba.perturb_state(t.gt_state, seed=seed + 7))


def test_object_frames_match():
    kw = dict(num_frames=8, imu_hz=100.0, num_landmarks=60, seed=1)
    fj, tj = jobj.make_object_frames(jsim.generate_sequence(**kw),
                                     num_objects=3, n_pts=20, seed=4)
    ft, tt = tobj.make_object_frames(tsim.generate_sequence(**kw),
                                     num_objects=3, n_pts=20, seed=4)
    for a, b in zip(tj, tt):
        assert a.track_id == b.track_id
        for k in ("dims", "v_obj", "p0", "q0", "gt_p"):
            np.testing.assert_allclose(getattr(b, k), np.asarray(
                getattr(a, k)), rtol=0, atol=ATOL, err_msg=k)
    assert len(fj) == len(ft) == 8
    n_right = 0
    for k, (a, b) in enumerate(zip(fj, ft)):
        assert a.keys() == b.keys(), k
        for tid in a:
            ia, ib = a[tid], b[tid]
            assert ia["cls"] == ib["cls"]
            assert ia["features"].keys() == ib["features"].keys()
            for l, (pl, pr) in ia["features"].items():
                ql, qr = ib["features"][l]
                np.testing.assert_allclose(ql, pl, rtol=0, atol=ATOL)
                assert (pr is None) == (qr is None)
                if pr is not None:
                    n_right += 1
                    np.testing.assert_allclose(qr, pr, rtol=0, atol=ATOL)
            for key in ("extra_pts_world", "dims_det", "q_det"):
                np.testing.assert_allclose(ib[key], np.asarray(ia[key]),
                                           rtol=0, atol=ATOL, err_msg=key)
    assert n_right > 0
