"""Epipolar outlier rejection: normalized 8-point F inside seeded RANSAC.

Reproduces what the JAX tracker asks of OpenCV's
`findFundamentalMat(p_prev, p_cur, FM_RANSAC, threshold, confidence)`:
F with p_curᵀ F p_prev = 0, OpenCV's per-point error (the larger of the
two squared point-to-epipolar-line distances, in pixels²) against
threshold², the adaptive iteration count RANSACUpdateNumIters with a
1000-iteration cap, and the inlier mask of the best model. Hypotheses
come from minimal 8-point samples (Hartley-normalized, rank-2
enforced), drawn from a seeded numpy Generator and scored in batches.
"""

from __future__ import annotations

import numpy as np

_BATCH = 64


def _normalize(p):
    """Hartley normalization of [..., n, 2] -> (T [...,3,3], p_norm)."""
    c = p.mean(axis=-2, keepdims=True)
    d = p - c
    s = np.sqrt(2.0) / np.maximum(
        np.linalg.norm(d, axis=-1).mean(axis=-1), 1e-12)
    T = np.zeros(p.shape[:-2] + (3, 3))
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * c[..., 0, 0]
    T[..., 1, 2] = -s * c[..., 0, 1]
    T[..., 2, 2] = 1.0
    return T, d * s[..., None, None]


def eight_point(p1, p2):
    """Normalized 8-point F (rank 2) from [..., n>=8, 2] pairs."""
    T1, q1 = _normalize(p1)
    T2, q2 = _normalize(p2)
    x1, y1 = q1[..., 0], q1[..., 1]
    x2, y2 = q2[..., 0], q2[..., 1]
    one = np.ones_like(x1)
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                  one], axis=-1)
    Fn = np.linalg.svd(A)[2][..., -1, :].reshape(p1.shape[:-2] + (3, 3))
    U, S, Vt = np.linalg.svd(Fn)
    S[..., 2] = 0.0
    Fn = U @ (S[..., :, None] * Vt)
    return np.swapaxes(T2, -1, -2) @ Fn @ T1


def epipolar_error(F, p1, p2):
    """OpenCV's FM error for models F [K,3,3] on pairs [n,2] -> [K,n]."""
    f = F.reshape(-1, 9)[:, :, None]
    x1, y1 = p1[None, :, 0], p1[None, :, 1]
    x2, y2 = p2[None, :, 0], p2[None, :, 1]
    a = f[:, 0] * x1 + f[:, 1] * y1 + f[:, 2]
    b = f[:, 3] * x1 + f[:, 4] * y1 + f[:, 5]
    c = f[:, 6] * x1 + f[:, 7] * y1 + f[:, 8]
    d2 = x2 * a + y2 * b + c
    s2 = 1.0 / np.maximum(a * a + b * b, 1e-300)
    a = f[:, 0] * x2 + f[:, 3] * y2 + f[:, 6]
    b = f[:, 1] * x2 + f[:, 4] * y2 + f[:, 7]
    c = f[:, 2] * x2 + f[:, 5] * y2 + f[:, 8]
    d1 = x1 * a + y1 * b + c
    s1 = 1.0 / np.maximum(a * a + b * b, 1e-300)
    return np.maximum(d1 * d1 * s1, d2 * d2 * s2)


def _update_num_iters(confidence, outlier_ratio, model_points, max_iters):
    """OpenCV's RANSACUpdateNumIters."""
    p = max(min(confidence, 1.0), 0.0)
    ep = max(min(outlier_ratio, 1.0), 0.0)
    num = max(1.0 - p, np.finfo(float).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(float).tiny:
        return 0
    num, denom = np.log(num), np.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) \
        else int(round(num / denom))


def ransac_fundamental(p1, p2, rng: np.random.Generator,
                       threshold: float = 1.0, confidence: float = 0.99,
                       max_iters: int = 1000):
    """Inlier mask [n] bool of the best RANSAC F, or None if n < 8."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    n = p1.shape[0]
    if n < 8:
        return None
    thr = threshold * threshold
    best_mask, best_count = None, -1
    niters, done = max_iters, 0
    while done < niters:
        k = min(_BATCH, niters - done)
        idx = np.argsort(rng.random((k, n)), axis=1)[:, :8]
        F = eight_point(p1[idx], p2[idx])
        ok = np.isfinite(F).all(axis=(1, 2))
        inl = (epipolar_error(F, p1, p2) <= thr) & ok[:, None]
        counts = inl.sum(axis=1)
        j = int(np.argmax(counts))
        if counts[j] > best_count:
            best_count = int(counts[j])
            best_mask = inl[j]
            niters = min(niters, _update_num_iters(
                confidence, (n - best_count) / n, 8, max_iters))
        done += k
    return best_mask
