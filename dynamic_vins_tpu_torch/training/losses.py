"""Supervised losses of the online perception nets, counterpart of the
JAX package's `training/losses.py`.

The target builders (`solo_grid_layout`, `solo_targets`,
`fcos3d_targets`) are host numpy, copied: they give the same arrays.
The losses are torch functions on tensors and take the port's
channels-first outputs, each permuted once, here:
  * `flow_loss`: RAFT's flow [B,2,H,W] (the JAX loss takes [B,H,W,2]);
  * `solo_loss`: SOLOv2's mask features [B,E,h,w] (JAX: [B,h,w,E]);
  * `fcos3d_loss`: FCOS3D's level outputs cls [B,C,h,w], ctr
    [B,1,h,w], reg [B,8,h,w]; the targets stay [B,h,w(,8)] as
    `data.det3d_batch` stacks them.
The gradient keeps JAX's tie semantics: `torch.maximum` against a tensor
splits a tie half and half, as `jnp.maximum` does (`clamp` and `relu`
give it all to one side); `amax` / `amin` spread it over equal entries,
as JAX's `.max` / `.min` do (`max(dim)` picks one); and `jnp.abs` has
slope 1 at 0 where `torch.abs` has 0 (`_abs`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _max(x, c: float):
    """`jnp.maximum(x, c)`: a tie splits the gradient half and half."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def _abs(x):
    """`jnp.abs`, whose gradient at 0 is 1 (torch.abs': 0)."""
    return torch.where(x >= 0, x, -x)


# ---------------------------------------------------------------------------
# generic pieces
# ---------------------------------------------------------------------------
def smooth_l1(x, beta: float = 1.0):
    ax = _abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Sigmoid focal loss; logits/targets same shape, targets in {0,1}."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    a_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return a_t * ((1.0 - p_t) ** gamma) * ce


def optax_sigmoid_ce(logits, labels):
    """Numerically stable sigmoid cross entropy."""
    return _max(logits, 0.0) - logits * labels + \
        torch.log1p(torch.exp(-_abs(logits)))


def dice_loss(prob, target, eps: float = 1.0):
    """Soft dice on flattened masks; prob/target [..., P]."""
    inter = torch.sum(prob * target, dim=-1)
    den = torch.sum(prob * prob, dim=-1) + torch.sum(target * target,
                                                     dim=-1)
    return 1.0 - (2.0 * inter + eps) / (den + eps)


def _masked_mean(err, valid):
    w = valid.to(err.dtype)
    return torch.sum(err * w) / _max(torch.sum(w), 1.0)


# ---------------------------------------------------------------------------
# stereo disparity (LEAStereo role)
# ---------------------------------------------------------------------------
def stereo_loss(pred_disp, gt_disp, valid):
    """Smooth-L1 over valid pixels; pred/gt [B,H,W], valid [B,H,W]."""
    return _masked_mean(smooth_l1(pred_disp - gt_disp), valid)


# ---------------------------------------------------------------------------
# optical flow (RAFT role)
# ---------------------------------------------------------------------------
def flow_loss(pred_flow, gt_flow, valid):
    """L1 endpoint error over valid pixels: pred_flow [B,2,H,W] (RAFT's
    final iteration), gt_flow [B,H,W,2], valid [B,H,W]."""
    err = torch.sum(_abs(pred_flow.permute(0, 2, 3, 1) - gt_flow),
                    dim=-1)
    return _masked_mean(err, valid)


# ---------------------------------------------------------------------------
# SOLOv2 instance segmentation
# ---------------------------------------------------------------------------
def solo_grid_layout(grid_sizes=(36, 24, 16, 12)):
    """Per-cell (level, y, x, grid_size) for the concatenated grid."""
    levels, ys, xs, sizes = [], [], [], []
    for lvl, s in enumerate(grid_sizes):
        yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        levels.append(np.full(s * s, lvl))
        ys.append(yy.ravel())
        xs.append(xx.ravel())
        sizes.append(np.full(s * s, s))
    return (np.concatenate(levels), np.concatenate(ys),
            np.concatenate(xs), np.concatenate(sizes))


# SOLOv2 FPN level scale ranges, in fraction of image diagonal — an
# instance is assigned to the level whose range contains sqrt(area).
_SOLO_SCALE_RANGES = ((0.0, 0.12), (0.08, 0.25), (0.2, 0.5), (0.4, 10.0))


def solo_targets(inst_masks, inst_labels, inst_valid,
                 grid_sizes=(36, 24, 16, 12), num_classes: int = 80,
                 center_sigma: float = 0.2):
    """Build per-grid-cell SOLOv2 training targets (host numpy).

    inst_masks: [N,H,W] bool, inst_labels: [N] int, inst_valid: [N].
    Returns (cate_target [G] int — num_classes = background,
             inst_index [G] int — which instance each positive cell
             segments, -1 for negatives).
    An instance is positive at the cells of its scale-assigned level
    whose centre falls in the shrunk (sigma) centre region of its mask.
    """
    levels, ys, xs, sizes = solo_grid_layout(grid_sizes)
    G = levels.shape[0]
    cate = np.full(G, num_classes, np.int32)
    inst_index = np.full(G, -1, np.int32)
    if inst_masks.shape[0] == 0:
        return cate, inst_index
    H, W = inst_masks.shape[1:]
    diag = float(np.hypot(H, W))
    for n in range(inst_masks.shape[0]):
        if not inst_valid[n]:
            continue
        m = inst_masks[n]
        area = float(m.sum())
        if area < 4:
            continue
        ys_m, xs_m = np.nonzero(m)
        cy, cx = float(ys_m.mean()), float(xs_m.mean())
        h_m = ys_m.max() - ys_m.min() + 1.0
        w_m = xs_m.max() - xs_m.min() + 1.0
        scale = float(np.sqrt(area)) / diag
        for lvl, (lo, hi) in enumerate(_SOLO_SCALE_RANGES):
            if not (lo <= scale <= hi):
                continue
            s = grid_sizes[lvl]
            # shrunk center region in grid coords
            top = max(0, int((cy - center_sigma * h_m / 2) / H * s))
            bot = min(s - 1, int((cy + center_sigma * h_m / 2) / H * s))
            lef = max(0, int((cx - center_sigma * w_m / 2) / W * s))
            rig = min(s - 1, int((cx + center_sigma * w_m / 2) / W * s))
            sel = (levels == lvl) & (ys >= top) & (ys <= bot) & \
                (xs >= lef) & (xs <= rig)
            cate[sel] = inst_labels[n]
            inst_index[sel] = n
    return cate, inst_index


def solo_loss(kernels, scores, mask_feat, cate_target, inst_index,
              gt_masks_low, num_classes: int = 80,
              mask_weight: float = 3.0):
    """SOLOv2 loss: focal on categories + dice on dynamic-conv masks.

    kernels [B,G,E], scores [B,G,C], mask_feat [B,E,h,w];
    cate_target [B,G] int (num_classes = background);
    inst_index [B,G] int (instance id per positive cell, -1 negative);
    gt_masks_low [B,N,h,w] float GT masks at mask_feat resolution.
    Computed in float32, as the JAX loss casts.
    """
    B = scores.shape[0]
    f32 = torch.float32
    cate_target = cate_target.long()
    onehot = F.one_hot(cate_target, num_classes + 1)[..., :num_classes]
    cate_l = focal_loss(scores.to(f32), onehot.to(f32))
    num_pos = _max(torch.sum(cate_target < num_classes).to(f32), 1.0)
    cate_l = torch.sum(cate_l) / num_pos

    e, h, w = mask_feat.shape[1:]
    # dynamic conv for EVERY cell (static shape), mask out negatives
    logits = torch.einsum("bge,bep->bgp", kernels.to(f32),
                          mask_feat.to(f32).reshape(B, e, h * w))
    prob = torch.sigmoid(logits)                        # [B,G,hw]
    tgt = gt_masks_low.reshape(B, -1, h * w)            # [B,N,hw]
    inst_index = inst_index.long()
    safe_idx = torch.clamp_min(inst_index, 0)           # integer: no grad
    tgt_g = torch.gather(tgt, 1, safe_idx[..., None].expand(
        -1, -1, h * w))                                 # [B,G,hw]
    pos = (inst_index >= 0).to(f32)
    d = dice_loss(prob, tgt_g.to(f32))                  # [B,G]
    mask_l = torch.sum(d * pos) / _max(torch.sum(pos), 1.0)
    return cate_l + mask_weight * mask_l, (cate_l, mask_l)


# ---------------------------------------------------------------------------
# FCOS3D monocular 3D detection
# ---------------------------------------------------------------------------
def fcos3d_targets(boxes_uvd, boxes_dims, boxes_yaw, boxes_label,
                   boxes_valid, image_hw, strides=(8, 16, 32, 64),
                   num_classes: int = 10, radius: float = 1.5):
    """Per-level dense targets for the FCOS3D head (host numpy).

    boxes_uvd: [N,3] projected 3D center (u, v pixels, depth m).
    Returns a list per level of dicts with 'cls' [h,w] int
    (num_classes = background), 'ctr' [h,w], 'reg' [h,w,8], 'pos' [h,w].
    Positives: locations within `radius * stride` of the projected
    center, assigned to the level whose stride matches the 2D extent.
    """
    H, W = image_hw
    out = []
    n = boxes_uvd.shape[0]
    ext = np.maximum(boxes_dims[:, 0], boxes_dims[:, 1]) if n else None
    for li, s in enumerate(strides):
        h, w = H // s, W // s
        cls = np.full((h, w), num_classes, np.int32)
        ctr = np.zeros((h, w), np.float32)
        reg = np.zeros((h, w, 8), np.float32)
        pos = np.zeros((h, w), bool)
        for i in range(n):
            if not boxes_valid[i]:
                continue
            u, v, d = boxes_uvd[i]
            if d <= 0.1:
                continue
            # level assignment by projected size (fx*ext/d pixels)
            px = 460.0 * float(ext[i]) / float(d)
            lo = s * 4 if li > 0 else 0
            hi = s * 8 if li < len(strides) - 1 else 1e9
            if not (lo <= px < hi):
                continue
            gu, gv = u / s - 0.5, v / s - 0.5
            iu, iv = int(round(gu)), int(round(gv))
            r = int(np.ceil(radius))
            for dv in range(-r, r + 1):
                for du in range(-r, r + 1):
                    yy, xx = iv + dv, iu + du
                    if not (0 <= yy < h and 0 <= xx < w):
                        continue
                    dist = np.hypot(gv - yy, gu - xx)
                    if dist > radius:
                        continue
                    c = float(np.exp(-0.5 * dist * dist))
                    if c <= ctr[yy, xx]:
                        continue   # keep the closest instance
                    cls[yy, xx] = boxes_label[i]
                    ctr[yy, xx] = c
                    pos[yy, xx] = True
                    reg[yy, xx] = [
                        gu - xx, gv - yy, np.log(max(d, 1e-3)),
                        np.log(max(boxes_dims[i, 0], 1e-3)),
                        np.log(max(boxes_dims[i, 1], 1e-3)),
                        np.log(max(boxes_dims[i, 2], 1e-3)),
                        np.sin(boxes_yaw[i]), np.cos(boxes_yaw[i])]
        out.append({"cls": cls, "ctr": ctr, "reg": reg, "pos": pos})
    return out


def fcos3d_loss(level_outputs, level_targets, num_classes: int = 10):
    """Focal (cls) + BCE (centerness) + smooth-L1 (reg at positives).

    level_outputs: per level (cls [B,C,h,w], ctr [B,1,h,w],
    reg [B,8,h,w]); level_targets: per level the stacked dicts of
    `fcos3d_targets` (cls [B,h,w], ctr [B,h,w], reg [B,h,w,8],
    pos [B,h,w]). Computed in float32, as the JAX loss casts."""
    f32 = torch.float32
    cls_l = ctr_l = reg_l = 0.0
    num_pos = 1e-6
    for (cls, ctr, reg), tgt in zip(level_outputs, level_targets):
        cls = cls.to(f32).permute(0, 2, 3, 1)
        ctr = ctr.to(f32)[:, 0]
        reg = reg.to(f32).permute(0, 2, 3, 1)
        onehot = F.one_hot(tgt["cls"].long(), num_classes + 1).to(
            f32)[..., :num_classes]
        cls_l = cls_l + torch.sum(focal_loss(cls, onehot))
        pos = tgt["pos"].to(f32)
        ctr_l = ctr_l + torch.sum(
            optax_sigmoid_ce(ctr, tgt["ctr"].to(f32)) * pos)
        reg_l = reg_l + torch.sum(
            torch.sum(smooth_l1(reg - tgt["reg"].to(f32)), -1) * pos)
        num_pos = num_pos + torch.sum(pos)
    return (cls_l + ctr_l + reg_l) / num_pos, \
        (cls_l / num_pos, ctr_l / num_pos, reg_l / num_pos)


# ---------------------------------------------------------------------------
# ReID appearance embeddings
# ---------------------------------------------------------------------------
def triplet_loss(emb, ids, margin: float = 0.3):
    """Batch-hard triplet loss on L2-normalized embeddings.

    emb [B,D] (normalized), ids [B] int identity labels."""
    d = 1.0 - emb @ emb.T                        # cosine distance
    same = ids[:, None] == ids[None, :]
    eye = torch.eye(ids.shape[0], dtype=torch.bool, device=emb.device)
    pos_d = torch.where(same & ~eye, d, -torch.inf).amax(dim=1)
    neg_d = torch.where(~same, d, torch.inf).amin(dim=1)
    has_pos = torch.isfinite(pos_d)
    l = _max(pos_d - neg_d + margin, 0.0)
    l = torch.where(has_pos, l, 0.0)
    return torch.sum(l) / _max(torch.sum(has_pos).to(l.dtype), 1.0)
