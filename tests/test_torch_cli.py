"""The port's CLI (`dynamic_vins_tpu_torch.run.main([... "--cpu"])`)
against the JAX package's (`dynamic_vins_tpu.run.main`) on the same
on-disk fixtures, as tests/test_fixture_datasets.py builds them, at a
size tier-1 affords (376x240 rendered frames, window 4-5, 8-9 frames):

  * EuRoC ASL layout, RAW stereo+IMU (cam0/cam1 CSV + PNG, imu0,
    ground truth, a YAML config);
  * VIODE layout, NAIVE, with segmentation PNGs whose car-coloured
    pixels become the dynamic mask;
  * KITTI tracking layout, DYNAMIC without IMU (stereo VO), with the
    offline SOLO `.pt`, FCOS3D txt and 16-bit disparity PNG artifacts;
    sequentially and `--pipelined`.

The PNGs are written by the port's encoder (the JAX side reads them
with OpenCV). Both TUM files hold the same timestamps and positions
within 1e-3 m; the KITTI-MOT files the same rows (frame, track id,
class), their numbers within 1e-3. In the DYNAMIC cases both Systems'
trackers are rebuilt in float64 right after construction (in float32
the object LM amplifies ~1e-4 px LK differences to centimetres, see
tests/test_torch_dynamic_system.py), and the JAX package's
`AsyncFetch.ready` joins its fetch thread, so both apply each object
solve at the same read.

Also: without `--cpu` the port's CLI runs on the card and raises where
there is none; `--loop-closure` runs; `--devices 2` raises naming its
ROADMAP item.

This file runs the EuRoC and the pipelined KITTI cases;
tests/test_torch_cli_viode_kitti.py runs the VIODE and the sequential
KITTI ones with this file's fixtures.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu import run as jrun
from dynamic_vins_tpu import system as jsystem
from dynamic_vins_tpu.frontend import instance_tracker as jit_
from dynamic_vins_tpu.frontend import tracker as jtr
from dynamic_vins_tpu.geometry import lie as jlie
from dynamic_vins_tpu.sim import dynamic_scene as jdyn
from dynamic_vins_tpu.sim import render, synthetic as jsim
from dynamic_vins_tpu.utils import prefetch
from dynamic_vins_tpu_torch import run as trun
from dynamic_vins_tpu_torch import system as tsystem
from dynamic_vins_tpu_torch.frontend import instance_tracker as tit
from dynamic_vins_tpu_torch.frontend import tracker as ttr
from dynamic_vins_tpu_torch.io import image_io, perception
from dynamic_vins_tpu_torch.io.writers import read_mot, read_tum

yaml = pytest.importorskip("yaml")
pytest.importorskip("cv2")

torch.set_num_threads(1)   # the xdist workers share the cores

POS_ATOL = 1e-3      # m
MOT_ATOL = 1e-3
CAR_BGR = (142, 0, 0)          # VIODE car, rgb (0, 0, 142)


def _rig_yaml(path, rig, **extra):
    T0 = np.eye(4)
    T0[:3, :3] = np.asarray(jlie.quat_to_matrix(rig.q_bc))
    T0[:3, 3] = np.asarray(rig.p_bc)
    pr, qr = rig.right_extrinsics()
    T1 = np.eye(4)
    T1[:3, :3] = np.asarray(jlie.quat_to_matrix(qr))
    T1[:3, 3] = np.asarray(pr)
    intr = [float(rig.intr.fx), float(rig.intr.fy), float(rig.intr.cx),
            float(rig.intr.cy)]
    d = dict(intrinsics_left=intr, intrinsics_right=list(intr),
             body_T_cam0=[float(v) for v in T0.reshape(-1)],
             body_T_cam1=[float(v) for v in T1.reshape(-1)],
             image_width=rig.width, image_height=rig.height,
             window_size=4, max_cnt=80, min_dist=10)
    d.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def _render(seq, rig, n):
    inten = render.make_intensities(int(seq.landmarks.shape[0]), seed=1)
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c), static_argnums=2)
    return [tuple(np.asarray(draw(seq.gt_p[k], seq.gt_q[k], c))
                  .astype(np.uint8) for c in (0, 1)) for k in range(n)]


def _ns(t, offset_ns=0):
    return int(round(float(t) * 1e9)) + offset_ns


def _imu_csv(path, seq, offset_ns=0):
    it, acc, gyr = (np.asarray(seq.imu_times), np.asarray(seq.acc),
                    np.asarray(seq.gyr))
    with open(path, "w") as f:
        f.write("#timestamp,w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(it.shape[0]):
            f.write(f"{_ns(it[i], offset_ns)},{gyr[i, 0]},{gyr[i, 1]},"
                    f"{gyr[i, 2]},{acc[i, 0]},{acc[i, 1]},{acc[i, 2]}\n")


def _gt_csv(path, seq, offset_ns=0):
    ft, p, q = (np.asarray(seq.frame_times), np.asarray(seq.gt_p),
                np.asarray(seq.gt_q))
    with open(path, "w") as f:
        f.write("#timestamp,p,q\n")
        for k in range(ft.shape[0]):
            f.write(f"{_ns(ft[k], offset_ns)},{p[k, 0]},{p[k, 1]},"
                    f"{p[k, 2]},{q[k, 0]},{q[k, 1]},{q[k, 2]},{q[k, 3]}\n")


def _sequence(n, seed, **kw):
    rig = render.small_rig(0.5, jnp.float64)
    seq = jsim.generate_sequence(num_frames=n, imu_hz=200.0,
                                 acc_noise=0.02, gyr_noise=0.002,
                                 num_landmarks=220, seed=seed, **kw)
    return rig, seq._replace(rig=rig)


def euroc_case(tmp_path):
    """EuRoC ASL tree, RAW."""
    n = 8
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
    cfg = _rig_yaml(tmp_path / "euroc.yaml", rig, dataset="euroc",
                    slam="raw", imu=1, acc_w=1.0e-3, gyr_w=1.0e-4)
    return ["--dataset", "euroc", "--root", str(root), "--config", cfg]


def viode_case(tmp_path):
    """VIODE tree, NAIVE: a car-coloured band in the segmentation."""
    n = 8
    rig, seq = _sequence(n, 4)
    imgs = _render(seq, rig, n)
    root = tmp_path / "viode"
    for d in ("cam0", "cam1", "segmentation"):
        os.makedirs(root / d / "data")
    ft = np.asarray(seq.frame_times)
    off = 10**18                # file-name stamps as a real capture has
    for k in range(n):
        name = f"{_ns(ft[k], off)}.png"
        for c, cam in enumerate(("cam0", "cam1")):
            image_io.imwrite(root / cam / "data" / name, imgs[k][c])
        seg = np.full((rig.height, rig.width, 3), 70, np.uint8)
        seg[:, 20 + 15 * k: 140 + 15 * k] = CAR_BGR
        image_io.imwrite(root / "segmentation" / "data" / name, seg)
    os.makedirs(root / "imu0")
    os.makedirs(root / "odometry")
    _imu_csv(root / "imu0" / "data.csv", seq, off)
    _gt_csv(root / "odometry" / "data.csv", seq, off)
    cfg = _rig_yaml(tmp_path / "viode.yaml", rig, dataset="viode",
                    slam="naive", imu=1)
    return ["--dataset", "viode", "--root", str(root), "--config", cfg]


def kitti_case(tmp_path):
    """KITTI tracking tree, DYNAMIC without IMU, offline artifacts."""
    n = 9
    rig, seq = _sequence(n, 9)
    frames, _ = jdyn.make_dynamic_scene(seq, num_objects=1, seed=9)
    left = tmp_path / "image_02" / "0000"
    right = tmp_path / "image_03" / "0000"
    os.makedirs(left)
    os.makedirs(right)
    arts = {d: str(tmp_path / d) for d in ("seg", "det3d", "disp")}
    for k, df in enumerate(frames):
        name = f"{k:06d}"
        image_io.imwrite(left / (name + ".png"),
                         np.asarray(df.img_left).astype(np.uint8))
        image_io.imwrite(right / (name + ".png"),
                         np.asarray(df.img_right).astype(np.uint8))
        perception.write_solo_seg_pt(arts["seg"], name, df.seg)
        perception.write_fcos3d_txt(
            os.path.join(arts["det3d"], name + ".txt"), df.boxes3d)
        perception.write_disparity_png(
            os.path.join(arts["disp"], name + ".png"), df.disparity)
    cfg = _rig_yaml(tmp_path / "kitti.yaml", rig, dataset="kitti",
                    slam="dynamic", imu=0, window_size=5, max_cnt=100,
                    mot_n_init=2)
    return ["--dataset", "kitti", "--left", str(left), "--right",
            str(right), "--seg-dir", arts["seg"], "--det3d-dir",
            arts["det3d"], "--disp-dir", arts["disp"], "--config", cfg,
            "--slam", "dynamic"]


def _landed(self):
    """AsyncFetch.ready for the parity runs: wait for the fetch."""
    self._thread.join()
    return True


def _float64_trackers(monkeypatch):
    """Both packages' Systems rebuild their trackers in float64 right
    after construction."""
    def jax_side(s):
        c = s.cfg
        p_bc, q_bc = c.extrinsics()
        s.tracker = jtr.FeatureTracker(jtr.TrackerConfig(
            max_cnt=c.max_cnt, min_dist=c.min_dist, stereo=c.is_stereo,
            dtype=jnp.float64), s.intr, s.intr_r)
        s.inst_tracker = jit_.InstanceTracker(jit_.InstanceTrackerConfig(
            max_dynamic_cnt=c.max_dynamic_cnt,
            min_dynamic_dist=c.min_dynamic_dist, dtype=jnp.float64),
            s.intr, s.baseline, p_bc[0], q_bc[0])

    def torch_side(s):
        c = s.cfg
        p_bc, q_bc = c.extrinsics()
        s.tracker = ttr.FeatureTracker(ttr.TrackerConfig(
            max_cnt=c.max_cnt, min_dist=c.min_dist, stereo=c.is_stereo,
            dtype=torch.float64), s.intr, s.intr_r, device=s.device)
        s.tracker.timer = s.timer
        s.inst_tracker = tit.InstanceTracker(tit.InstanceTrackerConfig(
            max_dynamic_cnt=c.max_dynamic_cnt,
            min_dynamic_dist=c.min_dynamic_dist, dtype=torch.float64),
            s.intr, s.baseline, p_bc[0], q_bc[0], device=s.device)

    for cls, rebuild in ((jsystem.System, jax_side),
                         (tsystem.System, torch_side)):
        def init(self, *a, _orig=cls.__init__, _rebuild=rebuild, **kw):
            _orig(self, *a, **kw)
            _rebuild(self)
        monkeypatch.setattr(cls, "__init__", init)


CASES = {"euroc_raw": (euroc_case, []),
         "viode_naive": (viode_case, []),
         "kitti_dynamic": (kitti_case, []),
         "kitti_dynamic_pipelined": (kitti_case, ["--pipelined"])}
# the cases of this file; tests/test_torch_cli_viode_kitti.py runs the
# others (one file runs in one xdist worker)
HERE = ("euroc_raw", "kitti_dynamic_pipelined")


@pytest.mark.parametrize("case", HERE)
def test_cli_matches_jax(tmp_path, monkeypatch, case, capsys):
    check_case(tmp_path, monkeypatch, case, capsys)


def check_case(tmp_path, monkeypatch, case, capsys):
    """Both CLIs on `case`'s tree: the comparison of the module
    docstring."""
    make, extra = CASES[case]
    args = make(tmp_path) + extra
    dynamic = "--slam" in args
    if dynamic:
        monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
        _float64_trackers(monkeypatch)
    out = {}
    for name, main in (("jax", jrun.main), ("torch", trun.main)):
        out[name] = str(tmp_path / f"{name}_run")
        assert main(args + ["--output", out[name], "--cpu"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("frames=") == 2
    tj, pj, qj = read_tum(out["jax"] + "_ego_tum.txt")
    tt, pt, qt = read_tum(out["torch"] + "_ego_tum.txt")
    assert len(tt) == len(tj) >= 8
    np.testing.assert_allclose(tt, tj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=POS_ATOL)
    if not dynamic:
        assert printed.count("ATE RMSE vs ground truth") == 2
        return
    rj = read_mot(out["jax"] + "_mot.txt")
    rt = read_mot(out["torch"] + "_mot.txt")
    assert rj and len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert (a["frame"], a["tid"], a["cls"]) == \
            (b["frame"], b["tid"], b["cls"])
        for key in ("bbox", "hwl", "xyz"):
            np.testing.assert_allclose(a[key], b[key], rtol=0,
                                       atol=MOT_ATOL, err_msg=key)
        assert abs(a["ry"] - b["ry"]) <= MOT_ATOL


@pytest.mark.parametrize("flag,match", [
    (["--devices", "2"], "ROADMAP.*item 18")])
def test_cli_unported_switches_raise(tmp_path, flag, match):
    args = ["--dataset", "synthetic", "--frames", "3", "--output",
            str(tmp_path / "run"), "--cpu"] + flag
    with pytest.raises(NotImplementedError, match=match):
        trun.main(args)


def test_cli_runs_with_loop_closure(tmp_path, monkeypatch):
    """--loop-closure builds the System's loop closer and runs: a pose
    for every frame; the synthetic dataset feeds features, not images,
    so no keyframe and no loop file."""
    built = []
    real_system = trun._system

    def spy(cfg, args):
        built.append(real_system(cfg, args))
        return built[-1]

    monkeypatch.setattr(trun, "_system", spy)
    trun.main(["--dataset", "synthetic", "--frames", "3", "--window", "4",
               "--output", str(tmp_path / "run"), "--cpu",
               "--loop-closure"])
    assert len(built) == 1 and built[0].cfg.use_loop_closure
    assert built[0].loop_closer is not None
    assert len(np.loadtxt(str(tmp_path / "run_ego_tum.txt"))) == 3
    assert not (tmp_path / "run_ego_tum_loop.txt").exists()


def test_cli_runs_on_the_card_unless_cpu(tmp_path):
    args = ["--dataset", "synthetic", "--frames", "6", "--window", "4",
            "--output", str(tmp_path / "run")]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(args)
    assert trun.main(args + ["--cpu", "--slam", "naive"]) == 0
    t, p, _ = read_tum(str(tmp_path / "run_ego_tum.txt"))
    assert len(t) == 6 and np.isfinite(p).all()
