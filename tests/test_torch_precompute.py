"""Port parity for the precompute tool (`tools/precompute.py`): the
port's `main --cpu` and the JAX package's on the same 2-frame KITTI
tracking tree (96x128 stereo PNGs: a segmentation generator scene, the
right image shifted by 4 px, the next frame by 2 px), tasks seg, det3d,
disp and flow with the shipped weights, give the same artifacts:
  * SOLOv2 masks: the same detections (count, labels; scores rtol
    1e-3), masks equal but for pixels whose probability lies within
    1e-3 of the 0.5 threshold (the port's probabilities);
  * FCOS3D boxes: every number of the text files within 1e-4 (they are
    printed to 4 decimals);
  * disparity PNGs: within 1 LSB (1/256 px);
  * flow fields: within 1e-3 px.
"""

import os

import numpy as np
import torch

from dynamic_vins_tpu.tools import precompute as jtool
from dynamic_vins_tpu_torch.io import image_io, perception
from dynamic_vins_tpu_torch.models import layers, pretrained, solov2
from dynamic_vins_tpu_torch.tools import precompute as ttool
from dynamic_vins_tpu_torch.training import data as tdata
from test_torch_models import jit_flax_init  # noqa: F401 (autouse)

torch.set_num_threads(1)   # the xdist workers share the cores

HW = (96, 128)


def kitti_tree(root):
    # seed 13: a scene the shipped SOLOv2 and FCOS3D detect something in
    # (a detection and two boxes on frame 0, two boxes on frame 1)
    img = tdata.seg_batch(np.random.default_rng(13), 1, HW,
                          grid_sizes=(12, 8, 6, 4))[0][0, ..., 0]
    left, right = root / "image_02" / "0000", root / "image_03" / "0000"
    left.mkdir(parents=True)
    right.mkdir(parents=True)
    frames = []
    for i in range(2):
        l = np.roll(img, 2 * i, axis=1).astype(np.uint8)
        image_io.imwrite(left / f"{i:06d}.png", l)
        image_io.imwrite(right / f"{i:06d}.png", np.roll(l, -4, axis=1))
        frames.append(l)
    return str(left), str(right), frames


def mask_probs(img):
    """The port's SOLOv2 mask probabilities of the kept detections."""
    det = pretrained.load_online("solo", HW, device="cpu")
    with torch.no_grad():
        prob, score, _ = solov2.decode_prob(
            *det.model(layers.normalize_image(img, device="cpu")), HW,
            score_thresh=det.score_thresh, max_dets=det.max_dets)
    return prob.numpy()[score.numpy() > 0]


def test_precompute_matches_jax(tmp_path):
    left, right, frames = kitti_tree(tmp_path / "kitti")
    outs = {}
    for name, tool, extra in (("jax", jtool, []), ("port", ttool, ["--cpu"])):
        outs[name] = str(tmp_path / name)
        assert tool.main(["--left", left, "--right", right, "--out",
                          outs[name], "--tasks", "seg,det3d,disp,flow",
                          "--intrinsics", "100,100,64,48"] + extra) == 0
    jo, to = outs["jax"], outs["port"]
    n_det = n_box = 0
    for i, img in enumerate(frames):
        name = f"{i:06d}"
        a = perception.read_solo_seg_pt(os.path.join(to, "seg"), name, 0.0)
        b = perception.read_solo_seg_pt(os.path.join(jo, "seg"), name, 0.0)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-3)
        near = np.abs(mask_probs(img) - 0.5) < 1e-3
        assert not ((a.masks != b.masks) & ~near).any()
        n_det += len(a.scores)

        ta = np.loadtxt(os.path.join(to, "det3d", name + ".txt"), ndmin=2)
        tb = np.loadtxt(os.path.join(jo, "det3d", name + ".txt"), ndmin=2)
        assert ta.shape == tb.shape
        np.testing.assert_allclose(ta, tb, rtol=0, atol=1e-4 + 1e-9)
        n_box += len(ta)

        da = image_io.imread(os.path.join(to, "disp", name + ".png"),
                             "unchanged").astype(np.int64)
        db = image_io.imread(os.path.join(jo, "disp", name + ".png"),
                             "unchanged").astype(np.int64)
        assert da.shape == HW and np.abs(da - db).max() <= 1
    fa = np.load(os.path.join(to, "flow", "000001.npy"))
    fb = np.load(os.path.join(jo, "flow", "000001.npy"))
    assert fa.shape == HW + (2,)
    np.testing.assert_allclose(fa, fb, rtol=0, atol=1e-3)
    assert not os.path.exists(os.path.join(to, "flow", "000000.npy"))
    assert n_det > 0 and n_box > 0, (n_det, n_box)
