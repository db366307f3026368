"""The port's entry points: they run on the CUDA device unless asked for
the CPU (and raise without a card rather than land on the CPU), and the
switches of paths not ported yet raise NotImplementedError naming their
ROADMAP item (NAIVE, DYNAMIC and LinePoint run on the sequential and
pipelined paths, mono+IMU, the extrinsic rotation calibration, dense
flow, the online nets and loop closure build; more than one card
raises)."""

import numpy as np
import pytest
import torch

from dynamic_vins_tpu_torch.estimator.estimator import (Estimator,
                                                        EstimatorConfig)
from dynamic_vins_tpu_torch.frontend.instance_tracker import (
    InstanceTracker, InstanceTrackerConfig)
from dynamic_vins_tpu_torch.frontend.tracker import (FeatureTracker,
                                                     TrackerConfig)
from dynamic_vins_tpu_torch.geometry.camera import PinholeIntrinsics
from dynamic_vins_tpu_torch.system import System
from dynamic_vins_tpu_torch.utils.config import SlamMode, VioConfig

torch.set_num_threads(1)   # the xdist workers share the cores

P_BC = np.zeros((2, 3))
Q_BC = np.tile([1.0, 0.0, 0.0, 0.0], (2, 1))
INTR = PinholeIntrinsics.make(460.0, 460.0, 376.0, 240.0)

def _mode(slam, **kw):
    cfg = VioConfig()
    cfg.slam = slam
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


ENTRY = {
    "system": lambda **kw: System(VioConfig(), output_prefix=kw.pop("out"),
                                  **kw),
    "system_naive": lambda **kw: System(_mode(SlamMode.NAIVE),
                                        output_prefix=kw.pop("out"), **kw),
    "system_dynamic": lambda **kw: System(_mode(SlamMode.DYNAMIC),
                                          output_prefix=kw.pop("out"),
                                          **kw),
    "system_linepoint": lambda **kw: System(
        _mode(SlamMode.RAW, use_line=True), output_prefix=kw.pop("out"),
        **kw),
    "instance_tracker": lambda **kw: InstanceTracker(
        InstanceTrackerConfig(), INTR, 0.11, P_BC[0], Q_BC[0],
        device=kw.get("device")),
    "estimator": lambda **kw: Estimator(EstimatorConfig(num_frames=4),
                                        P_BC, Q_BC, device=kw.get("device")),
    "tracker": lambda **kw: FeatureTracker(TrackerConfig(), INTR,
                                           device=kw.get("device")),
}


@pytest.mark.parametrize("name", sorted(ENTRY))
def test_default_device_is_cuda(name, tmp_path):
    out = str(tmp_path / "run")
    obj = ENTRY[name](device="cpu", out=out)
    assert obj.device == torch.device("cpu")
    if torch.cuda.is_available():
        assert ENTRY[name](out=out).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ENTRY[name](out=out)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("field", ["use_dense_flow", "use_loop_closure",
                                   "det2d_online"])
def test_unported_system_switches_raise(field, tmp_path):
    """Dense flow, the online nets and loop closure are ported: RAFT
    builds in every mode, SOLOv2 not in RAW (the JAX System's
    conditions); the loop closer builds on the System's device, and
    close() with no loop edge writes no loop file."""
    cfg = VioConfig()
    setattr(cfg, field, True)
    if field == "use_loop_closure":
        system = System(cfg, output_prefix=str(tmp_path / "run"),
                        device="cpu")
        assert system.loop_closer.device == torch.device("cpu")
        system.close()
        assert (tmp_path / "run_ego_tum.txt").exists()
        assert not (tmp_path / "run_ego_tum_loop.txt").exists()
        return
    system = System(cfg, output_prefix=str(tmp_path / "run"), device="cpu")
    assert (system.flow_net is not None) == (field == "use_dense_flow")
    assert system.det2d is None
    system.close()
    cfg.slam = SlamMode.NAIVE
    system = System(cfg, output_prefix=str(tmp_path / "run"), device="cpu")
    assert (system.det2d is not None) == (field == "det2d_online")
    system.close()


@pytest.mark.parametrize("mode", [SlamMode.NAIVE, SlamMode.DYNAMIC])
def test_unported_modes_raise(mode, tmp_path):
    """NAIVE and DYNAMIC are ported on the sequential and pipelined
    paths; on more than one card they raise, naming ROADMAP queue 1
    item 18."""
    cfg = _mode(mode)
    for pipelined in (False, True):
        cfg.pipelined = pipelined
        system = System(cfg, output_prefix=str(tmp_path / "run"),
                        device="cpu")
        assert (system.mot is not None) == (mode == SlamMode.DYNAMIC)
        assert (system.estimator.im is not None) == (mode
                                                     == SlamMode.DYNAMIC)
        assert system.estimator.cfg.pipelined == pipelined
        system.close()
    cfg.devices = 2
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 18"):
        System(cfg, output_prefix=str(tmp_path / "run"), device="cpu")


@pytest.mark.parametrize("mode", [SlamMode.RAW, SlamMode.NAIVE])
@pytest.mark.parametrize("pipelined", [False, True])
def test_use_line_builds_the_line_tracker_and_manager(mode, pipelined,
                                                      tmp_path):
    """`use_line` (LinePoint) builds the host line tracker and the
    estimator's LineManager on both paths, with the config's line
    weight."""
    cfg = _mode(mode, use_line=True, pipelined=pipelined, line_weight=0.5)
    system = System(cfg, output_prefix=str(tmp_path / "run"), device="cpu")
    est = system.estimator
    assert system.line_tracker is not None
    assert est.cfg.use_line and est.lines is not None
    assert est.lines.capacity == est.cfg.line_capacity == 64
    assert est.lines.obs_capacity == 512
    assert est._solver_cfg.line_weight == 0.5
    assert est._consts.use_line and est.cfg.pipelined == pipelined
    system.close()
    plain = System(_mode(mode), output_prefix=str(tmp_path / "run"),
                   device="cpu")
    assert plain.line_tracker is None and plain.estimator.lines is None
    plain.close()


@pytest.mark.parametrize("kw", [dict(mesh=object()),
                                dict(mesh=object(), use_line=True)])
def test_unported_estimator_paths_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Estimator(EstimatorConfig(num_frames=4, **kw), P_BC, Q_BC,
                  device="cpu")


@pytest.mark.parametrize("kw", [dict(stereo=False),
                                dict(stereo=False, pipelined=True),
                                dict(calibrate_extrinsic_rotation=True)])
def test_mono_and_calibration_build(kw):
    est = Estimator(EstimatorConfig(num_frames=4, **kw), P_BC, Q_BC,
                    device="cpu")
    assert est.cfg.stereo == kw.get("stereo", True)
    assert (est.ex_calib is not None) == \
        kw.get("calibrate_extrinsic_rotation", False)
