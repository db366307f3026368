"""OpenCV's `RANSACPointSetRegistrator`, step by step, in numpy.

The loop that `cv2.findFundamentalMat(FM_RANSAC)` and
`cv2.findEssentialMat(RANSAC)` share, with the model as callbacks, so
that the same points give the same inlier mask as OpenCV:
  * `cv::RNG` seeded with (uint64)-1 afresh on every call: next() is
    state = (uint32)state * 4164903690 + (state >> 32), returning the
    low 32 bits, and uniform(0, n) = next() % n;
  * `getSubset`: `model_points` distinct indices (a duplicate is
    redrawn); a subset the callback's `checkSubset` refuses is drawn
    anew, at most 10000 attempts, after which the loop stops;
  * every model of a sample is scored by its callback's per-point error
    (float32) against float32(threshold^2); a model replaces the best
    only when its count exceeds max(best, model_points - 1), and then
    the iteration count becomes RANSACUpdateNumIters(confidence,
    outlier share, model_points, niters), from a cap of `max_iters`.
Samples are drawn in batches (4, doubling up to 64: the iteration count
usually drops to a few after the first model) and their models solved
and scored at once; the walk over them is sequential, as OpenCV's loop,
so the batching changes no result.
"""

from __future__ import annotations

import math

import numpy as np

_BATCH = 64
_DBL_MIN = float(np.finfo(np.float64).tiny)


class CvRng:
    """`cv::RNG`: multiply-with-carry on a 64-bit state."""

    def __init__(self, state: int = 0xFFFFFFFFFFFFFFFF):
        self.state = state

    def next(self) -> int:
        s = self.state
        s = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) & 0xFFFFFFFFFFFFFFFF
        self.state = s
        return s & 0xFFFFFFFF

    def uniform(self, n: int) -> int:
        return self.next() % n


def draw_subsets(rng: CvRng, n: int, model_points: int, count: int,
                 check=None):
    """The next `count` subsets `getSubset` returns -> ([<=count, m] int,
    gave_up): fewer when 10000 attempts in a row fail `check(idx)`, after
    which OpenCV stops drawing."""
    out = []
    while len(out) < count:
        for _ in range(10000):
            idx = []
            for _ in range(model_points):
                k = rng.uniform(n)
                while k in idx:
                    k = rng.uniform(n)
                idx.append(k)
            if check is None or check(idx):
                out.append(idx)
                break
        else:
            return np.asarray(out, np.int64).reshape(-1, model_points), True
    return np.asarray(out, np.int64).reshape(-1, model_points), False


def update_num_iters(confidence, outlier_ratio, model_points, max_iters):
    """OpenCV's RANSACUpdateNumIters."""
    p = max(min(confidence, 1.0), 0.0)
    ep = max(min(outlier_ratio, 1.0), 0.0)
    num = max(1.0 - p, _DBL_MIN)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < _DBL_MIN:
        return 0
    num, denom = math.log(num), math.log(denom)
    return max_iters if denom >= 0 or -num >= max_iters * (-denom) \
        else int(round(num / denom))


def ransac(n: int, model_points: int, solve, error, threshold: float,
           confidence: float, max_iters: int = 1000, check=None):
    """The registrator's loop over n point pairs -> (inlier mask [n] bool,
    model) of the best model, or (None, None) when no model counted.

    solve(idx [K, m]) -> K lists of models (the callback's runKernel);
    error(models [M, ...]) -> [M, n] float32 (its computeError);
    check(idx) -> bool (its checkSubset; None accepts every subset)."""
    thr = np.float32(threshold * threshold)
    rng = CvRng()
    best_mask, best_model, best_count = None, None, 0
    niters, it, batch = max(max_iters, 1), 0, 4
    while it < niters:
        idx, gave_up = draw_subsets(rng, n, model_points,
                                    min(batch, niters - it), check)
        batch = min(2 * batch, _BATCH)
        models = solve(idx)
        flat = [M for ms in models for M in ms]
        if flat:
            inl = error(np.stack(flat)) <= thr
            counts = inl.sum(axis=1)
        j = 0
        for ms in models:
            if it >= niters:
                break
            for _ in ms:
                if counts[j] > max(best_count, model_points - 1):
                    best_count = int(counts[j])
                    best_mask, best_model = inl[j], flat[j]
                    niters = update_num_iters(
                        confidence, (n - best_count) / n, model_points,
                        niters)
                j += 1
            it += 1
        if gave_up:
            break
    return best_mask, best_model
