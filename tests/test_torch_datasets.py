"""Port parity for the CLI's inputs and evaluation: the dataset readers,
the offline perception files, `VioConfig.from_yaml` and the trajectory
and MOT metrics, each against the JAX package's on the same files.

  * EuRoC, KITTI tracking, KITTI raw (with OXTS ground truth) and VIODE
    trees as tests/test_io.py builds them (PNGs written by OpenCV):
    equal IMU samples, frames (timestamps, images and segmentation to
    the byte) and ground truth; KITTI calib files; VIODE masks.
  * The perception artifacts written by the JAX package's writers (SOLO
    `.pt` tensors, FCOS3D txt, 16-bit disparity PNG) and a KITTI label
    file read alike; the port's writers give files the JAX readers read
    alike.
  * `from_yaml` (the port's own parser) against JAX's (PyYAML) on a rig
    config written by `yaml.safe_dump` (block lists) and with flow
    lists, and on a hand-written file with comments, quoting and flow
    lists over lines: every field equal.
  * `ate_rmse` (aligned, unaligned, with scale), `rpe`, `clear_mot`
    (2D and 3D association) and the MOT file helpers: equal to 1e-12.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.io import datasets as jds
from dynamic_vins_tpu.io import eval_tools as jet
from dynamic_vins_tpu.io import evaluation as jev
from dynamic_vins_tpu.io import perception as jpe
from dynamic_vins_tpu.utils.config import VioConfig as JVioConfig
from dynamic_vins_tpu_torch.io import datasets as tds
from dynamic_vins_tpu_torch.io import eval_tools as tet
from dynamic_vins_tpu_torch.io import evaluation as tev
from dynamic_vins_tpu_torch.io import perception as tpe
from dynamic_vins_tpu_torch.utils.config import VioConfig as TVioConfig
from dynamic_vins_tpu_torch.utils.config import parse_flat_yaml

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

torch.set_num_threads(1)   # the xdist workers share the cores


def _same(a, b):
    """Equal nested reader outputs: arrays to the byte and dtype."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


def _euroc_tree(root, rng):
    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
    (root / "mav0" / "imu0").mkdir(parents=True)
    (root / "mav0" / "state_groundtruth_estimate0").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(3):
        ts = 1000000000 + i * 50000000
        for cam in ("cam0", "cam1"):
            cv2.imwrite(str(root / "mav0" / cam / "data" / f"{ts}.png"),
                        rng.integers(0, 256, (48, 64), np.uint8))
        rows.append(f"{ts},{ts}.png")
    rows.append("1150000000,missing.png")        # no image: skipped
    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data.csv").write_text("\n".join(rows))
    imu = ["#timestamp,wx,wy,wz,ax,ay,az"]
    for i in range(10):
        imu.append(f"{1000000000 + i * 5000000},0.01,0.02,{0.03 * i},"
                   f"0.1,0.2,9.8")
    (root / "mav0" / "imu0" / "data.csv").write_text("\n".join(imu))
    gt = ["#timestamp,p,q"] + [
        f"{1000000000 + i * 50000000},{0.1 * i},0.2,0.3,1.0,0.0,0.0,0.0"
        for i in range(3)]
    (root / "mav0" / "state_groundtruth_estimate0" / "data.csv") \
        .write_text("\n".join(gt))


def test_euroc_reader_matches(tmp_path):
    _euroc_tree(tmp_path / "MH_01", np.random.default_rng(0))
    j = jds.EurocDataset(str(tmp_path / "MH_01"))
    t = tds.EurocDataset(str(tmp_path / "MH_01"))
    _same([tuple(s) for s in t.imu()], [tuple(s) for s in j.imu()])
    _same(list(map(tuple, t.frames())), list(map(tuple, j.frames())))
    assert len(list(t.frames())) == 3
    _same(t.ground_truth(), j.ground_truth())


def test_kitti_tracking_reader_matches(tmp_path):
    rng = np.random.default_rng(1)
    left, right = tmp_path / "image_02" / "0000", tmp_path / "image_03"
    left.mkdir(parents=True)
    right.mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(left / f"{i:06d}.png"),
                    rng.integers(0, 256, (40, 70), np.uint8))
        if i != 1:                               # a missing right image
            cv2.imwrite(str(right / f"{i:06d}.png"),
                        rng.integers(0, 256, (40, 70, 3), np.uint8))
    for r in (None, str(right)):
        fj = list(map(tuple, jds.KittiTrackingDataset(str(left), r)
                      .frames()))
        ft = list(map(tuple, tds.KittiTrackingDataset(str(left), r)
                      .frames()))
        _same(ft, fj)
        assert len(ft) == 3


def test_kitti_calib_and_raw_match(tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text("P2: " + " ".join(str(float(i)) for i in range(12))
                     + "\nR0_rect: " + " ".join(["1.0"] * 9)
                     + "\nT: 1 2\nno colon here\n")
    _same(tds.parse_kitti_calib(str(calib)),
          jds.parse_kitti_calib(str(calib)))
    drive = tmp_path / "2011_09_26_drive_0001_sync"
    for cam in ("image_00", "image_01"):
        d = drive / cam / "data"
        d.mkdir(parents=True)
        with open(drive / cam / "timestamps.txt", "w") as f:
            for i in range(3):
                f.write(f"2011-09-26 13:02:{25 + i:02d}.500000000\n")
        for i in range(3):
            cv2.imwrite(str(d / f"{i:010d}.png"),
                        np.full((40, 60), i * 40, np.uint8))
    oxts = drive / "oxts" / "data"
    oxts.mkdir(parents=True)
    with open(drive / "oxts" / "timestamps.txt", "w") as f:
        for i in range(3):
            f.write(f"2011-09-26 13:02:{25 + i:02d}.500000000\n")
    for i in range(3):
        vals = np.zeros(30)
        vals[0], vals[1], vals[2] = 49.0, 8.43 + i * 1e-5, 110.0
        vals[5] = 0.1 * i
        np.savetxt(oxts / f"{i:010d}.txt", vals[None])
    j, t = jds.KittiRawDataset(str(drive)), tds.KittiRawDataset(str(drive))
    _same(list(map(tuple, t.frames())), list(map(tuple, j.frames())))
    gj = j.oxts_ground_truth(str(tmp_path / "gt_j.txt"))
    gt = t.oxts_ground_truth(str(tmp_path / "gt_t.txt"))
    _same(gt, gj)
    assert (tmp_path / "gt_t.txt").read_text() == \
        (tmp_path / "gt_j.txt").read_text()


def test_viode_reader_and_masks_match(tmp_path):
    root = tmp_path / "viode"
    for d in ("cam0", "cam1", "segmentation"):
        (root / d / "data").mkdir(parents=True)
    (root / "imu0").mkdir()
    (root / "odometry").mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        t_ns = 1403636579763555584 + i * 100_000_000
        img = rng.integers(0, 255, (48, 64), np.uint8)
        cv2.imwrite(str(root / "cam0" / "data" / f"{t_ns}.png"), img)
        cv2.imwrite(str(root / "cam1" / "data" / f"{t_ns}.png"), img)
        seg = rng.integers(0, 256, (48, 64, 3), np.uint8)
        seg[10:20, 10:20] = (142, 0, 0)       # BGR of car rgb(0,0,142)
        seg[30:40, 30:45] = (60, 20, 220)     # BGR of person
        cv2.imwrite(str(root / "segmentation" / "data" / f"{t_ns}.png"),
                    seg)
    with open(root / "imu0" / "data.csv", "w") as f:
        f.write("#ts,gx,gy,gz,ax,ay,az\n")
        for k in range(10):
            f.write(f"{1403636579763555584 + k * 5_000_000},"
                    "0.01,0.02,0.03,0.1,0.2,9.8\n")
    with open(root / "odometry" / "data.csv", "w") as f:
        for i in range(3):
            t_ns = 1403636579763555584 + i * 100_000_000
            f.write(f"{t_ns},{0.1 * i},0.0,0.0,1.0,0.0,0.0,0.0\n")
    j, t = jds.ViodeDataset(str(root)), tds.ViodeDataset(str(root))
    fj, ft = list(map(tuple, j.frames())), list(map(tuple, t.frames()))
    _same(ft, fj)
    assert ft[0][3] is not None
    _same([tuple(s) for s in t.imu()], [tuple(s) for s in j.imu()])
    _same(t.ground_truth(), j.ground_truth())
    for f in ft:
        _same(tds.viode_dynamic_mask(f[3]), jds.viode_dynamic_mask(f[3]))
        _same(tds.viode_instance_masks(f[3], min_area=10),
              jds.viode_instance_masks(f[3], min_area=10))
    assert tds.viode_dynamic_mask(ft[0][3])[15, 15]


def _seg(rng, n=3, h=30, w=40):
    return tpe.SegResult(rng.random((n, h, w)) < 0.3,
                         np.array([0.9, 0.2, 0.5])[:n],
                         np.array([2, 0, 7])[:n])


def test_perception_files_match(tmp_path):
    rng = np.random.default_rng(3)
    boxes = [tpe.Box3D("Car", 0.8, np.array([1.0, 1.5, 12.0]),
                       np.array([4.0, 1.6, 1.8]), 0.3),
             tpe.Box3D("Pedestrian", 0.1, np.zeros(3), np.ones(3), 0.0),
             tpe.Box3D("Truck", 0.5, np.array([-3.0, 1.2, 20.0]),
                       np.array([8.0, 3.0, 2.5]), -1.2)]
    disp = rng.uniform(0, 90, (30, 40)).astype(np.float32)
    for side, pe in (("j", jpe), ("t", tpe)):
        pe.write_solo_seg_pt(str(tmp_path / side), "000001",
                             _seg(np.random.default_rng(4)))
        pe.write_fcos3d_txt(str(tmp_path / side / "000001.txt"), boxes)
        pe.write_disparity_png(str(tmp_path / side / "000001.png"), disp)
    for side in ("j", "t"):
        d = str(tmp_path / side)
        _same(tuple(tpe.read_solo_seg_pt(d, "000001")),
              tuple(jpe.read_solo_seg_pt(d, "000001")))
        _same([tuple(b) for b in tpe.read_fcos3d_txt(d + "/000001.txt")],
              [tuple(b) for b in jpe.read_fcos3d_txt(d + "/000001.txt")])
        _same(tpe.read_disparity_png(d + "/000001.png"),
              jpe.read_disparity_png(d + "/000001.png"))
    assert (tmp_path / "t" / "000001.txt").read_text() == \
        (tmp_path / "j" / "000001.txt").read_text()
    assert tpe.read_solo_seg_pt(str(tmp_path / "t"), "000002") is None
    assert tpe.read_disparity_png(str(tmp_path / "none.png")) is None
    labels = tmp_path / "0000.txt"
    labels.write_text(
        "0 1 Car 0 0 -1.5 10 20 110 120 1.5 1.8 4.0 2.0 1.0 15.0 0.3\n"
        "0 2 Pedestrian 0.1 1 0.2 50 60 70 120 1.7 0.6 0.8 -1 1.6 9 1.0\n"
        "1 1 Car 0 0 -1.5 12 20 112 120 1.5 1.8 4.0 2.1 1.0 14.0 0.3\n"
        "short line\n")
    _same(tpe.read_kitti_tracking_labels(str(labels)),
          jpe.read_kitti_tracking_labels(str(labels)))


def _cfg_dict(cfg):
    """The port's VioConfig fields (and seq_name) of a config of either
    package, enums by value."""
    names = [f.name for f in dataclasses.fields(TVioConfig)] + ["seq_name"]
    return {n: (v.value if hasattr(v, "value") else v)
            for n in names for v in [getattr(cfg, n)]}


RIG = dict(
    intrinsics_left=[229.325, 228.65, 183.6, 124.2],
    intrinsics_right=[229.325, 228.65, 183.6, 124.2, -0.2834, 0.0739,
                      1.9359e-04, 1.76187114e-05],
    body_T_cam0=[float(v) for v in np.random.default_rng(5).normal(
        size=16)],
    body_T_cam1=[0.0, 0.0, 1.0, 0.11, -1.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0,
                 0.0, 0.0, 0.0, 0.0, 1.0],
    image_width=376, image_height=240, window_size=5, max_cnt=100,
    min_dist=10, dataset="kitti", slam="dynamic", imu=0, mot_n_init=2,
    acc_n=0.08, gyr_n=0.004, acc_w=1.0e-3, gyr_w=1e-4, is_stereo=True,
    pipelined=1, output_dir="out dir", F_threshold=1.5, unknown_key=[1, 2])

HAND = """%s
# a hand-written config
slam: naive          # mask-gated
dataset: 'viode'
imu: 1
is_stereo: false
max_cnt: 0x96        # 150
min_dist: 1_2
keyframe_parallax: .5e+1
F_threshold: 1
acc_n: "0.1"
basic_dir: "a \\"quoted\\" dir"
intrinsics_left: [376.0, 376, 376.0, 240.0,  # fx fy cx cy
                  -0.01, 0.002, 0, 0]
intrinsics_right: [376.0,376.0,376.0,240.0]
body_T_cam0: [0, 0, 1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1]
body_T_cam1:
- 0
- 0
-  1     # comment
- 0.05
- 1
- 0
- 0
- 0
- 0
- 1
- 0
- 0
- 0.0
- 0.0
- 0.0
- 1.0
empty:
window_size: ~
"""


@pytest.mark.parametrize("source", ["safe_dump_block", "safe_dump_flow",
                                    "hand_written", "document_marker"])
def test_from_yaml_matches(tmp_path, source):
    path = tmp_path / "cfg.yaml"
    if source == "safe_dump_block":
        text = yaml.safe_dump(RIG)
    elif source == "safe_dump_flow":
        text = yaml.safe_dump(RIG, default_flow_style=None)
    else:
        text = HAND % ("---" if source == "document_marker" else "")
    path.write_text(text)
    assert parse_flat_yaml(text) == yaml.safe_load(text)
    cj = JVioConfig.from_yaml(str(path), "0003")
    ct = TVioConfig.from_yaml(str(path), "0003")
    assert _cfg_dict(ct) == _cfg_dict(cj)
    _same(ct.extrinsics(), cj.extrinsics())


@pytest.mark.parametrize("text,where", [
    ("a: 1\nb:\n  c: 2\n", ":3"), ("a: &x 1\n", ":1"),
    ("a: [1, [2]]\n", ":1"), ("- 1\n", ":1"), ("a: 1:30\n", ":1"),
    ("a: {b: 1}\n", ":1"), ("a: |\n  text\n", ":1"), ("x: 1\nplain\n", ":2"),
    ("a: 'open\n", ":1"), ("a: [1, 2\n", ":1")])
def test_from_yaml_refuses_what_it_does_not_read(tmp_path, text, where):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"bad.yaml{where}"):
        TVioConfig.from_yaml(str(path))


def _trajectories(seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    t = np.arange(40) * 0.1
    p_gt = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    q_gt = Rotation.from_rotvec(np.cumsum(rng.normal(scale=0.1,
                                                     size=(40, 3)), 0))
    q_gt = np.roll(q_gt.as_quat(), 1, axis=1)          # wxyz
    p_est = 1.3 * p_gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]) \
        + rng.normal(scale=0.05, size=p_gt.shape) + 2.0
    q_est = q_gt + rng.normal(scale=0.01, size=q_gt.shape)
    q_est /= np.linalg.norm(q_est, axis=1, keepdims=True)
    t_est = t[::2] + rng.normal(scale=0.003, size=20)
    return t, p_gt, q_gt, t_est, p_est[::2], q_est[::2]


@pytest.mark.parametrize("seed", [0, 1])
def test_trajectory_metrics_match(seed):
    t, p_gt, q_gt, t_est, p_est, q_est = _trajectories(seed)
    _same(tuple(tev.associate(t_est, t)), tuple(jev.associate(t_est, t)))
    for kw in (dict(align=True), dict(align=False),
               dict(align=True, with_scale=True)):
        a = tev.ate_rmse(t_est, p_est, t, p_gt, **kw)
        b = jev.ate_rmse(t_est, p_est, t, p_gt, **kw)
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
    for delta in (1, 3):
        a = tev.rpe(t_est, p_est, q_est, t, p_gt, q_gt, delta=delta)
        b = jev.rpe(t_est, p_est, q_est, t, p_gt, q_gt, delta=delta)
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    assert tev.rpe(t_est[:1], p_est[:1], q_est[:1], t, p_gt, q_gt) \
        == pytest.approx((np.nan, np.nan), nan_ok=True)


def _mot_rows(rng, n_frames=12, drop=0.2, jitter=4.0):
    gt, est = [], []
    for f in range(n_frames):
        for tid in range(3):
            x = 50.0 + 100 * tid + 5 * f
            box = [x, 40.0, x + 60, 100.0]
            xyz = [tid * 3.0 - 3, 1.5, 10.0 + f]
            gt.append(dict(frame=f, tid=tid, cls="Car", bbox=box, xyz=xyz,
                           hwl=[1.5, 1.8, 4.0], ry=0.1))
            if rng.random() > drop:
                e_tid = tid + (10 if f > 6 and tid == 1 else 0)
                est.append(dict(
                    frame=f, tid=e_tid, cls="Car",
                    bbox=list(np.asarray(box) + rng.normal(scale=jitter,
                                                           size=4)),
                    xyz=list(np.asarray(xyz) + rng.normal(scale=0.5,
                                                          size=3)),
                    hwl=[1.5, 1.8, 4.0], ry=0.1))
        if f % 5 == 0:
            est.append(dict(frame=f, tid=99, cls="Car",
                            bbox=[0.0, 0.0, 10.0, 10.0], xyz=[0, 0, 5.0],
                            hwl=[1.5, 1.8, 4.0], ry=0.0))
    return gt, est


@pytest.mark.parametrize("use_3d", [False, True])
def test_clear_mot_matches(tmp_path, use_3d):
    gt, est = _mot_rows(np.random.default_rng(6))
    mj = jet.clear_mot(gt, est, iou_thresh=0.4, use_3d=use_3d)
    mt = tet.clear_mot(gt, est, iou_thresh=0.4, use_3d=use_3d)
    assert mt.as_dict() == pytest.approx(mj.as_dict(), rel=1e-12)
    assert mt.id_switches > 0 and mt.fp > 0 and mt.fn > 0
    # the MOT file helpers on a written file
    from dynamic_vins_tpu_torch.io.writers import KittiMotWriter

    path = str(tmp_path / "mot.txt")
    with KittiMotWriter(path) as w:
        for r in est:
            w.write(r["frame"], r["tid"], r["cls"], r["bbox"], r["hwl"],
                    r["xyz"], r["ry"], score=0.9)
    _same(tet.read_mot_file(path), jet.read_mot_file(path))
    for fn in ("split_mot_to_single", "split_mot_to_tum",
               "convert_tracking_to_object"):
        rt = getattr(tet, fn)(path, str(tmp_path / f"t_{fn}"))
        rj = getattr(jet, fn)(path, str(tmp_path / f"j_{fn}"))
        assert rt == rj
        for name in sorted(os.listdir(tmp_path / f"j_{fn}")):
            assert (tmp_path / f"t_{fn}" / name).read_text() == \
                (tmp_path / f"j_{fn}" / name).read_text()
