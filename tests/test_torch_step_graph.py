"""The steady-state steps as CUDA graph chains (utils/step_graph.py).

On the CPU: the steps run eagerly through StepGraph, leave their inputs
as they were, and issue no operation that would synchronize with the
host (which stream capture refuses) outside the `host_synced` calls;
a dispatch mode stands in for the capture and counts the segments.
LinePoint's steps (the line-only refinement and the line blocks' 4x4
solves in elementwise ops) add no host synchronization. The object BA
step (DYNAMIC) has no `host_synced` call at all: one graph.

On the card (`gpu` marker; skips without one): a replay of each
branch's chain equals the eager step on the same inputs (masks
identical, positions within 1e-6 m, float64), for the sequential and
the pipelined step, with and without lines (orth within 1e-6), and
every steady frame was one replay; a replay of the object step equals
its eager run within 1e-9 (float64). This file
imports no JAX, so the card's machine runs it as

    python -m pytest tests/test_torch_step_graph.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from dynamic_vins_tpu_torch.estimator import step_check
from dynamic_vins_tpu_torch.estimator.instance_manager import (
    InstanceConfig, InstanceManager, solve_layouts)
from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                        EstimatorConfig)
from dynamic_vins_tpu_torch.sim import frontend_sim, synthetic as sim
from dynamic_vins_tpu_torch.utils import step_graph

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 9
POS_ATOL = 1e-6       # m
# aten ops that read a device value on the host or copy host data in
SYNC_OPS = {"aten::_local_scalar_dense", "aten::nonzero",
            "aten::_linalg_check_errors", "aten::masked_select",
            "aten::lift_fresh", "aten::repeat_interleave",
            "aten::_linalg_eigh", "aten::_linalg_svd"}


def _run(device, pipelined=False, record=False, lines=False):
    """A window-5 stereo+IMU estimator over FRAMES frames, 4 of them
    steady, with `lines` LinePoint on 40 world segments: (estimator,
    its step graph, outputs, the step function and, with `record`, the
    inputs of each steady frame's step)."""
    seq = sim.generate_sequence(num_frames=FRAMES, imu_hz=200.0,
                                num_landmarks=150, seed=2)
    frames = frontend_sim.make_frames(seq, max_feats=80, pixel_noise=0.4)
    if lines:
        s_w, e_w = frontend_sim.make_line_segments(40, seed=9)
        frames = [(f._replace(lines=frontend_sim.line_obs_for_frame(
            seq, k, s_w, e_w, np.random.default_rng(100 + k))), imu)
            for k, (f, imu) in enumerate(frames)]
    pr, qr = seq.rig.right_extrinsics()
    p_bc = np.stack([seq.rig.p_bc.numpy(), pr.numpy()])
    q_bc = np.stack([seq.rig.q_bc.numpy(), qr.numpy()])
    est = Estimator(EstimatorConfig(num_frames=5, lm_capacity=160,
                                    obs_capacity=1024, pipelined=pipelined,
                                    use_line=lines, line_capacity=48,
                                    line_obs_capacity=256,
                                    dtype=torch.float64),
                    p_bc, q_bc, device=device)
    est.set_initial_pose(seq.gt_p[0].numpy(), seq.gt_q[0].numpy(),
                         sim.state_at(seq.frame_times[0])[2].numpy())
    graph = est._pipe if pipelined else est._mega
    fn, calls = graph.fn, []
    if record:
        def recorded(key, inputs):
            calls.append((key, pytree.tree_map(torch.clone, inputs)))
            return fn(key, inputs)

        graph.fn = recorded
    outs = [est.process_frame(f, imu) for f, imu in frames]
    outs = [o for o in outs if o is not None] + est.flush()
    assert est.initialized and not est.failed
    if lines:
        assert est.lines.orth_valid.sum() >= 5
    return est, graph, outs, fn, calls


class _SyncProbe(TorchDispatchMode):
    """Records aten ops that would synchronize with the host."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        bool_index = name in ("aten::index", "aten::index_put_") and any(
            isinstance(t, torch.Tensor) and t.dtype == torch.bool
            for t in (args[1] if len(args) > 1 else ()) if t is not None)
        if name in SYNC_OPS or bool_index:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


class _FakeChain:
    """Stands in for a capture: counts the host-synced calls (segment
    boundaries) and runs them outside the probe."""

    def __init__(self):
        self.calls = []

    def split(self, fn, args):
        self.calls.append(fn.__name__)
        with _disable_current_modes():
            return tuple(fn(*args))


@pytest.fixture(scope="module")
def cpu_runs():
    return {(p, lines): _run("cpu", pipelined=p, record=True, lines=lines)
            for p in (False, True) for lines in (False, True)}


@pytest.mark.parametrize("lines", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("keyframe", [True, False])
def test_step_is_capturable(cpu_runs, pipelined, keyframe, lines):
    """No host synchronization in either branch of either step, with or
    without lines, but at its 3 host-synced calls (the triangulation's
    batched SVD and the marginalization's two eighs), and the inputs
    stay untouched."""
    _, _, _, step, calls = cpu_runs[pipelined, lines]
    assert len(calls) == FRAMES - 5
    _, inputs = calls[-1]
    before = pytree.tree_map(torch.clone, inputs)
    probe, chain = _SyncProbe(), _FakeChain()
    token = step_graph._CAPTURE.set(chain)
    try:
        with probe:
            step(keyframe, inputs)
    finally:
        step_graph._CAPTURE.reset(token)
    assert probe.seen == []
    assert chain.calls == ["linalg_svd", "linalg_eigh", "linalg_eigh"]
    for a, b in zip(pytree.tree_leaves(before), pytree.tree_leaves(inputs)):
        assert torch.equal(a, b)


def test_step_graph_runs_eagerly_on_the_cpu():
    seen = []

    def fn(key, inputs):
        seen.append(key)
        a, b = inputs
        w, V = step_graph.host_synced(torch.linalg.eigh, a @ a.T)
        return (V * w) @ V.T + b

    g = step_graph.StepGraph(fn, "cpu", keys=("x", "y"))
    a = torch.randn(4, 4, dtype=torch.float64)
    out = g("x", (a, torch.ones(4, 4, dtype=torch.float64)))
    torch.testing.assert_close(out, a @ a.T + 1.0)
    assert seen == ["x"] and not g.on_card and g.chains == {}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("lines", [False, True])
@pytest.mark.parametrize("pipelined", [False, True])
def test_replay_equals_eager_step(cuda_device, pipelined, lines):
    est, graph, outs, _, _ = _run(cuda_device, pipelined=pipelined,
                                  lines=lines)
    assert sum(graph.replays.values()) == FRAMES - 5
    assert len(outs) == FRAMES
    assert all(np.isfinite(o.p).all() for o in outs)
    for key in (True, False):
        assert graph.segments(key) == 4 and graph.host_syncs(key) == 3
        eager = graph.fn(key, graph.inputs)
        replay = graph.replay(key)
        agree = step_check.agreement(est._consts, eager, replay)
        assert agree["masks_equal"], (key, agree)
        assert agree["pos_m"] <= POS_ATOL, (key, agree)
        assert agree["prior_rel"] <= 1e-6, (key, agree)
        if lines:
            assert agree["orth"] <= POS_ATOL, (key, agree)


def _object_run(device, frames=5):
    """An instance manager (window 5, 4 slots) over a box 8 m ahead of a
    static stereo rig (left camera at the origin looking along +z,
    right camera 0.11 m along x), moving at 1 m/s along x, 24 surface
    points, stereo features and noisy extra points a frame; the object
    step runs every frame. Returns (manager, the inputs of the step's
    last eager run)."""
    rng = np.random.default_rng(0)
    im = InstanceManager(InstanceConfig(num_frames=5, max_objects=4,
                                        dtype=torch.float64), device=device)
    dims = np.array([4.0, 2.0, 1.5])
    pts_obj = rng.uniform(-0.5, 0.5, size=(24, 3)) * dims
    times = np.arange(5) * 0.1
    ident = np.array([1.0, 0, 0, 0])
    p_bc = [np.zeros(3), np.array([0.11, 0.0, 0.0])]
    p_cw = np.stack([np.stack([-p for p in p_bc])] * 5)
    q_cw = np.tile(ident, (5, 2, 1))
    graph, calls = im.solve_graph, []
    fn = graph.fn

    def recorded(key, inputs):
        calls.append(pytree.tree_map(torch.clone, inputs))
        return fn(key, inputs)

    graph.fn = recorded
    for k in range(frames):
        center = np.array([-1.0 + 1.0 * times[k], 0.3, 8.0])
        pw = pts_obj + center
        feats = {}
        for i, x in enumerate(pw):
            feats[i] = (np.array([x[0] / x[2], x[1] / x[2], 1.0]),
                        np.array([(x[0] - 0.11) / x[2], x[1] / x[2], 1.0]))
        inst = {3: dict(cls=2, features=feats, dims_det=dims, q_det=ident,
                        extra_pts_world=pw + rng.normal(scale=0.02,
                                                        size=pw.shape))}
        im.push_frame(k, inst, np.zeros(3), ident, p_bc[0], ident)
        im.propagate_pose(k, times)
        im.initialize_instances(k)
        im.triangulate(k, np.zeros(3), ident, p_bc[0], ident,
                       (p_bc[1], ident))
        im.init_velocity(k, times)
        im.classify_motion(k, times)
        im.optimize(times, p_cw, q_cw)
        im.manage()
    out = im.output()
    assert 3 in out and np.isfinite(out[3]["p"]).all()
    # on the card the step function runs only to capture (warm-up and
    # capture), then the graph replays
    assert len(calls) == (2 if graph.on_card else frames)
    return im, calls[-1]


def test_object_step_is_capturable():
    """The object BA (vmapped jacfwd LM, Cholesky without a host check)
    makes no host synchronization and leaves its inputs untouched."""
    im, inputs = _object_run("cpu")
    before = pytree.tree_map(torch.clone, inputs)
    probe, chain = _SyncProbe(), _FakeChain()
    token = step_graph._CAPTURE.set(chain)
    try:
        with probe:
            out = im.solve_graph.fn(0, inputs)
    finally:
        step_graph._CAPTURE.reset(token)
    assert probe.seen == []
    assert chain.calls == []
    assert out.shape == (solve_layouts(im.cfg)[2].size,)
    for a, b in zip(pytree.tree_leaves(before), pytree.tree_leaves(inputs)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_object_step_replay_equals_eager(cuda_device):
    im, _ = _object_run(cuda_device)
    graph = im.solve_graph
    assert graph.replays[0] == 5
    assert graph.segments(0) == 1 and graph.host_syncs(0) == 0
    eager = graph.fn(0, graph.inputs)
    replay = graph.replay(0).clone()
    torch.testing.assert_close(replay, eager, rtol=0, atol=1e-9)
