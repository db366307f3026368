"""The LinePoint estimator protocol of tests/test_line_e2e.py, shortened
for the port's parity tests (tests/test_torch_linepoint*.py): the
synthetic stereo+IMU sequence with 120 landmarks, 40 world segments
(`make_line_segments`, seed 9) projected into both cameras with 0.3 px
noise, drawn once and fed to both packages, and a window of 6."""

import numpy as np

from dynamic_vins_tpu.estimator.estimator import Estimator as JEstimator
from dynamic_vins_tpu.estimator.estimator import \
    EstimatorConfig as JEstimatorConfig
from dynamic_vins_tpu.estimator.estimator import \
    FrameFeatures as JFrameFeatures
from dynamic_vins_tpu.sim import frontend_sim as jfs
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu_torch.estimator.estimator import Estimator as TEstimator
from dynamic_vins_tpu_torch.estimator.estimator import \
    EstimatorConfig as TEstimatorConfig
from dynamic_vins_tpu_torch.estimator.estimator import \
    FrameFeatures as TFrameFeatures

KW = dict(num_frames=6, lm_capacity=256, obs_capacity=2048, use_line=True,
          line_capacity=48, line_obs_capacity=384)


def scene(frames: int):
    seq = jsim.generate_sequence(num_frames=frames, imu_hz=200.0,
                                 acc_noise=0.02, gyr_noise=0.002,
                                 num_landmarks=120, seed=0)
    feats = jfs.make_frames(seq, pixel_noise=0.5, seed=0)
    s_w, e_w = jfs.make_line_segments(40, seed=9)
    lines = [jfs.line_obs_for_frame(seq, k, s_w, e_w,
                                    np.random.default_rng(100 + k))
             for k in range(frames)]
    rig = seq.rig
    p_bc = np.stack([np.asarray(rig.p_bc),
                     np.asarray(rig.right_extrinsics()[0])])
    q_bc = np.stack([np.asarray(rig.q_bc),
                     np.asarray(rig.right_extrinsics()[1])])
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    return dict(seq=seq, feats=feats, lines=lines, p_bc=p_bc, q_bc=q_bc,
                v0=v0, s_w=s_w, e_w=e_w)


def run(sc, port: bool, steps=None, **kw):
    """Drive one estimator over the scene. Returns (estimator, outputs,
    per-frame line snapshots (active slots' ids, orth_valid, orth))."""
    cfg = (TEstimatorConfig if port else JEstimatorConfig)(**KW, **kw)
    args = dict(device="cpu") if port else {}
    est = (TEstimator if port else JEstimator)(cfg, sc["p_bc"], sc["q_bc"],
                                               **args)
    est.set_initial_pose(np.asarray(sc["seq"].gt_p[0]),
                         np.asarray(sc["seq"].gt_q[0]), sc["v0"])
    FF = TFrameFeatures if port else JFrameFeatures
    outs, snaps = [], []
    n = len(sc["feats"]) if steps is None else steps
    for k in range(n):
        frame, imu = sc["feats"][k]
        o = est.process_frame(FF(frame.timestamp, frame.features,
                                 sc["lines"][k]), imu)
        if o is not None:
            outs.append(o)
        lm = est.lines
        snaps.append((lm.line_id.copy(), lm.active.copy(),
                      lm.orth_valid.copy(), lm.orth.copy()))
    return est, outs, snaps


def assert_lines_match(snaps_t, snaps_j, atol=1e-6):
    """Equal active / orth_valid sets every frame, orth within atol."""
    for k, (a, b) in enumerate(zip(snaps_t, snaps_j)):
        for x, y, name in zip(a[:3], b[:3], ("line_id", "active",
                                              "orth_valid")):
            np.testing.assert_array_equal(x, y, err_msg=f"{name} @ {k}")
        m = a[2]
        np.testing.assert_allclose(a[3][m], b[3][m], rtol=0, atol=atol,
                                   err_msg=f"orth @ {k}")


def system_scene(frames: int = 6):
    """tests/test_system.py's LinePoint scene: the rendered 376x240
    stereo frames (seed 4, 200 landmarks) with 12 world segments drawn
    into both images as bright 2 px strokes (cv2.line, as the JAX test
    draws them). Returns (seq, rig, [(t, img_l, img_r, imu)])."""
    import cv2
    import jax
    import jax.numpy as jnp

    from dynamic_vins_tpu.geometry import camera as jcam
    from dynamic_vins_tpu.geometry import lie as jlie
    from dynamic_vins_tpu.sim import render

    rig = render.small_rig(0.5, jnp.float64)
    seq = jsim.generate_sequence(num_frames=frames, imu_hz=200.0,
                                 num_landmarks=200, seed=4)._replace(rig=rig)
    inten = render.make_intensities(200, seed=4)
    frames_imu = jfs.make_frames(seq)
    rng = np.random.default_rng(5)
    centers = np.asarray(jsim.make_landmarks(12, seed=7))
    d = rng.normal(size=(12, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s_w, e_w = centers - d, centers + d
    draw = jax.jit(lambda p, q, c: render.render_frame(
        rig, p, q, seq.landmarks, inten, cam=c), static_argnums=2)

    def draw_lines(img, k, cam):
        extr = [(rig.p_bc, rig.q_bc), rig.right_extrinsics()][cam]
        p_cw, q_cw = jlie.pose_inverse(*jlie.pose_compose(
            seq.gt_p[k], seq.gt_q[k], extr[0], extr[1]))
        img = np.ascontiguousarray(np.asarray(img).astype(np.uint8))
        for l in range(len(s_w)):
            pts = []
            for w in (s_w[l], e_w[l]):
                pc = np.asarray(jlie.pose_transform_point(p_cw, q_cw,
                                                          jnp.asarray(w)))
                if pc[2] < 0.5:
                    break
                uv = np.asarray(jcam.pixel_from_normalized(
                    rig.intr, jnp.asarray(pc[:2] / pc[2])))
                pts.append(tuple(np.round(uv).astype(int)))
            if len(pts) == 2:
                cv2.line(img, pts[0], pts[1], 255, 2)
        return img

    out = []
    for k in range(frames):
        il = draw_lines(draw(seq.gt_p[k], seq.gt_q[k], 0), k, 0)
        ir = draw_lines(draw(seq.gt_p[k], seq.gt_q[k], 1), k, 1)
        out.append((float(seq.frame_times[k]), il, ir, frames_imu[k][1]))
    return seq, rig, out


def system_configs(rig, **kw):
    """(JAX VioConfig, port VioConfig) of tests/test_system.py's
    _make_cfg with use_line on."""
    from dynamic_vins_tpu.geometry import lie as jlie
    from dynamic_vins_tpu.utils.config import VioConfig as JVioConfig
    from dynamic_vins_tpu_torch.utils.config import VioConfig as TVioConfig

    T0, T1 = np.eye(4), np.eye(4)
    T0[:3, :3] = np.asarray(jlie.quat_to_matrix(rig.q_bc))
    T0[:3, 3] = np.asarray(rig.p_bc)
    pr, qr = rig.right_extrinsics()
    T1[:3, :3] = np.asarray(jlie.quat_to_matrix(qr))
    T1[:3, 3] = np.asarray(pr)
    out = []
    for cfg in (JVioConfig(), TVioConfig()):
        cfg.window_size = 4
        cfg.max_cnt = 80
        cfg.min_dist = 10
        cfg.image_width, cfg.image_height = rig.width, rig.height
        cfg.intrinsics_left = [float(rig.intr.fx), float(rig.intr.fy),
                               float(rig.intr.cx), float(rig.intr.cy)]
        cfg.body_T_cam0 = T0.reshape(-1).tolist()
        cfg.body_T_cam1 = T1.reshape(-1).tolist()
        cfg.use_line = True
        for k, v in kw.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def run_systems(tmp_path, frames_in, seq, rig, **kw):
    """The JAX and the port LinePoint Systems over the same images:
    per frame (output, the estimator's active line ids) of each, after
    the drain."""
    from dynamic_vins_tpu.system import FrameInput as JFrameInput
    from dynamic_vins_tpu.system import System as JSystem
    from dynamic_vins_tpu_torch.system import FrameInput as TFrameInput
    from dynamic_vins_tpu_torch.system import System as TSystem

    jcfg, tcfg = system_configs(rig, **kw)
    js = JSystem(jcfg, output_prefix=str(tmp_path / "jax"))
    ts = TSystem(tcfg, output_prefix=str(tmp_path / "torch"), device="cpu")
    v0 = np.asarray(jsim.state_at(seq.frame_times[0])[2])
    res = {}
    for name, s, FI in (("jax", js, JFrameInput), ("torch", ts, TFrameInput)):
        s.estimator.set_initial_pose(np.asarray(seq.gt_p[0]),
                                     np.asarray(seq.gt_q[0]), v0)
        outs, ids = [], []
        for t, il, ir, imu in frames_in:
            outs.append(s.process(FI(t, il, ir, imu=imu)))
            lm = s.estimator.lines
            ids.append(sorted(int(i) for i in lm.line_id[lm.active]))
        outs += s.drain()
        stages = s.close()
        res[name] = (s, [o for o in outs if o is not None], ids, stages)
    return res
