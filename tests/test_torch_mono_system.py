"""Port parity: mono+IMU end to end through the CLI, against the JAX
package's, on the CPU: an EuRoC ASL tree of 376x240 rendered frames (12
frames, window 5) with a YAML config that sets `is_stereo: 0`, run
through `run.main([... "--cpu"])` on both sides. The trackers track the
left camera only, both estimators initialize by the essential matrix
and SfM (the JAX side through OpenCV), and the TUM files hold the same
timestamps and positions within 1e-3 m (the trackers' float32 LK sums
in other orders move points by ~1e-4 px)."""

import os

import numpy as np
import pytest
import torch

from dynamic_vins_tpu import run as jrun
from dynamic_vins_tpu_torch import run as trun
from dynamic_vins_tpu_torch.io import image_io
from dynamic_vins_tpu_torch.io.writers import read_tum
from test_torch_cli import (_gt_csv, _imu_csv, _ns, _render, _rig_yaml,
                            _sequence)

pytest.importorskip("yaml")
pytest.importorskip("cv2")
torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-3
FRAMES = 12


def mono_euroc_case(tmp_path, n=FRAMES):
    """EuRoC tree (its readers read both cameras) and a mono+IMU
    config."""
    rig, seq = _sequence(n, 7)
    imgs = _render(seq, rig, n)
    root = tmp_path / "euroc"
    ft = np.asarray(seq.frame_times)
    for c, cam in enumerate(("cam0", "cam1")):
        os.makedirs(root / "mav0" / cam / "data")
        with open(root / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for k in range(n):
                ns = _ns(ft[k])
                image_io.imwrite(root / "mav0" / cam / "data" / f"{ns}.png",
                                 imgs[k][c])
                f.write(f"{ns},{ns}.png\n")
    os.makedirs(root / "mav0" / "imu0")
    os.makedirs(root / "mav0" / "state_groundtruth_estimate0")
    _imu_csv(root / "mav0" / "imu0" / "data.csv", seq)
    _gt_csv(root / "mav0" / "state_groundtruth_estimate0" / "data.csv", seq)
    cfg = _rig_yaml(tmp_path / "mono.yaml", rig, dataset="euroc",
                    slam="raw", imu=1, is_stereo=0, window_size=5,
                    acc_w=1.0e-3, gyr_w=1.0e-4)
    return ["--dataset", "euroc", "--root", str(root), "--config", cfg]


def test_mono_cli_matches_jax(tmp_path, capsys):
    args = mono_euroc_case(tmp_path)
    out = {}
    for name, main in (("jax", jrun.main), ("torch", trun.main)):
        out[name] = str(tmp_path / f"{name}_run")
        assert main(args + ["--output", out[name], "--cpu"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("ATE RMSE vs ground truth") == 2
    tj, pj, qj = read_tum(out["jax"] + "_ego_tum.txt")
    tt, pt, qt = read_tum(out["torch"] + "_ego_tum.txt")
    assert len(tt) == len(tj) == FRAMES
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=POS_ATOL)
