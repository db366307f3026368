"""Port parity of the LinePoint System (points + lines, stereo+IMU) on
tests/test_system.py's 6-frame line scene (376x240, window 4, 12 world
segments drawn as bright 2 px strokes; tests/linepoint_scene.py): the
images are drawn here with cv2 and given to both packages, whose
trackers detect with their own LSD (the port's reproduces cv2's). The
outputs agree within 1e-3 m (the point trackers' float32 LK sums in
other orders move points by ~1e-4 px) and the estimators hold the same
line ids every frame. The pipelined port System gives an output for
every frame, in order, with the same line ids once drained; and the CLI
with `use_line: 1` in its config builds the line tracker and the line
landmarks."""

import os

import numpy as np
import pytest
import torch

import linepoint_scene as scene

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-3


@pytest.fixture(scope="module")
def frames():
    return scene.system_scene(6)


@pytest.fixture(scope="module")
def runs(frames, tmp_path_factory):
    seq, rig, fr = frames
    return scene.run_systems(tmp_path_factory.mktemp("lp"), fr, seq, rig)


def test_linepoint_system_matches_jax(runs, frames):
    js, oj, idj, _ = runs["jax"]
    ts, ot, idt, stages = runs["torch"]
    assert ts.line_tracker is not None and ts.estimator.lines is not None
    assert not ts.estimator.failed
    assert [o.timestamp for o in ot] == [o.timestamp for o in oj]
    assert len(ot) == 6
    np.testing.assert_allclose(np.stack([o.p for o in ot]),
                               np.stack([o.p for o in oj]), rtol=0,
                               atol=POS_ATOL)
    assert idt == idj and len(idt[-1]) > 0
    assert "fe.lsd" in stages
    # the trackers' last segments, ids and endpoints
    assert [tuple(s) for s in ts.line_tracker.prev_segs] == \
        [tuple(s) for s in js.line_tracker.prev_segs]


def test_linepoint_system_pipelined(runs, frames, tmp_path):
    from dynamic_vins_tpu_torch.system import FrameInput, System

    seq, rig, fr = frames
    _, tcfg = scene.system_configs(rig, pipelined=True)
    s = System(tcfg, output_prefix=str(tmp_path / "pipe"), device="cpu")
    s.estimator.set_initial_pose(
        np.asarray(seq.gt_p[0]), np.asarray(seq.gt_q[0]),
        np.asarray(scene.jsim.state_at(seq.frame_times[0])[2]))
    outs = [s.process(FrameInput(t, il, ir, imu=imu))
            for t, il, ir, imu in fr]
    outs = [o for o in outs if o is not None] + s.drain()
    s.close()
    assert [o.timestamp for o in outs] == [f[0] for f in fr]
    assert not s.estimator.failed
    _, _, idt, _ = runs["torch"]
    lm = s.estimator.lines
    assert sorted(int(i) for i in lm.line_id[lm.active]) == idt[-1]
    seq_p = np.stack([o.p for o in runs["torch"][1]])
    # the pipelined estimator triangulates against lagged poses: close,
    # not equal, to the sequential run
    assert np.abs(np.stack([o.p for o in outs]) - seq_p).max() < 0.05


def test_cli_use_line(frames, tmp_path, monkeypatch, capsys):
    """`use_line: 1` in a YAML config reaches the System through the
    port's CLI."""
    from dynamic_vins_tpu_torch import run as trun
    from dynamic_vins_tpu_torch import system as tsys
    from dynamic_vins_tpu_torch.io import image_io
    from test_torch_cli import _gt_csv, _imu_csv, _ns, _rig_yaml

    seq, rig, fr = frames
    root = tmp_path / "euroc"
    for c, cam in enumerate(("cam0", "cam1")):
        os.makedirs(root / "mav0" / cam / "data")
        with open(root / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t, *imgs in fr:
                ns = _ns(t)
                image_io.imwrite(root / "mav0" / cam / "data" / f"{ns}.png",
                                 imgs[c])
                f.write(f"{ns},{ns}.png\n")
    os.makedirs(root / "mav0" / "imu0")
    os.makedirs(root / "mav0" / "state_groundtruth_estimate0")
    _imu_csv(root / "mav0" / "imu0" / "data.csv", seq)
    _gt_csv(root / "mav0" / "state_groundtruth_estimate0" / "data.csv", seq)
    cfg = _rig_yaml(tmp_path / "lines.yaml", rig, dataset="euroc",
                    slam="raw", imu=1, use_line=1, acc_w=1.0e-3,
                    gyr_w=1.0e-4)
    seen = []
    close = tsys.System.close

    def spy(self):
        seen.append((self.cfg.use_line, self.line_tracker,
                     self.estimator.lines.active.sum(),
                     self.timer.counts.get("fe.lsd", 0)))
        return close(self)

    monkeypatch.setattr(tsys.System, "close", spy)
    assert trun.main(["--dataset", "euroc", "--root", str(root),
                      "--config", cfg, "--output", str(tmp_path / "run"),
                      "--cpu"]) == 0
    assert "frames=6" in capsys.readouterr().out
    (use_line, tracker, n_active, n_lsd), = seen
    assert use_line and tracker is not None
    assert n_active > 0 and n_lsd == 6
