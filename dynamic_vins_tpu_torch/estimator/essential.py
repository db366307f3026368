"""Relative pose from the essential matrix: OpenCV's five-point RANSAC and
`recoverPose`, in numpy.

Reproduces, on normalized points, the two calls of the JAX package's
`initializer.solve_relative_pose`:

    E, mask = cv2.findEssentialMat(p1, p2, focal=1.0, pp=(0.0, 0.0),
                                   method=cv2.RANSAC, prob, threshold)
    n, R, t, _ = cv2.recoverPose(E, p1, p2, focal=1.0, pp=(0.0, 0.0),
                                 mask=mask)

so that the same points give the same inlier mask and pose.
`findEssentialMat` runs the classic `RANSACPointSetRegistrator`
(`frontend/ransac.py`: cv::RNG from (uint64)-1 on every call, 5-point
subsets, RANSACUpdateNumIters with 5 points, a cap of 1000) with the EM
callback, which checks no subset:
  * the points in float64 (FM rounds them to float32);
  * `runKernel`: the 4-D null space of the sample's 5x9 epipolar system,
    E = x E0 + y E1 + z E2 + E3, and the up to 10 real solutions of
    det(E) = 0, 2 E E^T E - tr(E E^T) E = 0, each E scaled to unit norm.
    OpenCV eliminates to a degree-10 polynomial (Nister) and finds its
    roots iteratively; here the ten cubic constraints are eliminated
    onto the ten monomials of degree <= 2 and the solutions are the
    eigenvectors of the action matrix of x (Stewenius). Both give the
    same set of essential matrices; the null-space basis and the order
    of a sample's models differ, which changes no mask: the error does
    not depend on E's scale or sign, and two models of one sample that
    tie in count but not in mask (where the order would decide) are
    not seen in practice (tests/test_torch_essential.py);
  * `computeError`: the squared Sampson distance, rounded to float32,
    against float32(threshold^2).
`recoverPose` decomposes E (`decomposeEssentialMat`: SVD with det(U),
det(V^T) made positive, R1 = U W V^T, R2 = U W^T V^T, t = U[:, 2]),
triangulates every pair for the four poses (R1, t), (R2, t), (R1, -t),
(R2, -t) by DLT (`triangulatePoints`), keeps the points in front of
both cameras and nearer than `distance_thresh` (50, in units of the
baseline), ANDs with the RANSAC mask and takes the pose with the most
points, the first on a tie.
"""

from __future__ import annotations

import numpy as np

from dynamic_vins_tpu_torch.frontend import ransac

MODEL_POINTS = 5
MIN_POINTS = 15       # solve_relative_pose's floor (initializer.py)
_IMAG_TOL = 1e-10     # runKernel's test for a real root

# monomials of x, y, z: the ten cubics, then the quotient basis
_CUBIC = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
          (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
          (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]


def _monomial_map():
    """[64, 20]: a product of three factors of (x, y, z, 1), indexed
    (a, b, c), to its monomial's column (cubics, then the basis)."""
    cols = {m: i for i, m in enumerate(_CUBIC + _BASIS)}
    M = np.zeros((4, 4, 4, 20))
    for a, b, c in np.ndindex(4, 4, 4):
        e = [0, 0, 0]
        for v in (a, b, c):
            if v < 3:
                e[v] += 1
        M[a, b, c, cols[tuple(e)]] = 1.0
    return M.reshape(64, 20)


_MONO = _monomial_map()
_EPS3 = np.zeros((3, 3, 3))
for _i, _j, _k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
    _EPS3[_i, _j, _k], _EPS3[_i, _k, _j] = 1.0, -1.0

# the action matrix of x on the basis: x * basis[r] is the cubic
# _CUBIC[r] for r < 6, else the basis monomial _X_TIMES[r]
_X_TIMES = {6: 0, 7: 1, 8: 2, 9: 6}


def _null_basis(m1, m2):
    """[K,4,3,3]: E0..E3, the last four right singular vectors of each
    sample's 5x9 system x2^T E x1 = 0 (runKernel's Q)."""
    x1, y1 = m1[..., 0], m1[..., 1]
    x2, y2 = m2[..., 0], m2[..., 1]
    Q = np.stack([x1 * x2, y1 * x2, x2, x1 * y2, y1 * y2, y2, x1, y1,
                  np.ones_like(x1)], axis=-1)
    Vt = np.linalg.svd(Q, full_matrices=True)[2]
    return Vt[:, 5:9].reshape(-1, 4, 3, 3)


def _constraints(c):
    """[K,10,20]: det(E) and the nine entries of 2 E E^T E - tr(E E^T) E
    for E = x c0 + y c1 + z c2 + c3, over the monomials."""
    K = c.shape[0]
    det = np.einsum("ijk,nai,nbj,nck->nabc", _EPS3, c[:, :, 0, :],
                    c[:, :, 1, :], c[:, :, 2, :])
    EEt = np.einsum("naij,nbkj->nabik", c, c)
    tr = np.einsum("nabii->nab", EEt)
    cub = 2.0 * np.einsum("nabik,nckl->nabcil", EEt, c) \
        - np.einsum("nab,ncil->nabcil", tr, c)
    rows = np.concatenate([det.reshape(K, 64, 1),
                           cub.reshape(K, 64, 9)], axis=2)
    return np.einsum("nmr,mc->nrc", rows, _MONO)


def five_point(m1, m2):
    """The EM callback's runKernel for [K,5,2] float64 samples -> list of
    K lists of unit-norm 3x3 essential matrices (x2^T E x1 = 0)."""
    m1 = np.asarray(m1, np.float64)
    m2 = np.asarray(m2, np.float64)
    c = _null_basis(m1, m2)
    A = _constraints(c)
    out = []
    for k in range(c.shape[0]):
        try:
            G = np.linalg.solve(A[k, :, :10], A[k, :, 10:])
        except np.linalg.LinAlgError:
            out.append([])
            continue
        Mx = np.zeros((10, 10))
        Mx[:6] = -G[:6]
        for r, s in _X_TIMES.items():
            Mx[r, s] = 1.0
        w, V = np.linalg.eig(Mx)
        models = []
        for i in range(10):
            if abs(w[i].imag) > _IMAG_TOL:
                continue
            b = V[:, i].real
            if abs(b[9]) < 1e-10:
                continue
            x, y, z = b[6] / b[9], b[7] / b[9], b[8] / b[9]
            E = x * c[k, 0] + y * c[k, 1] + z * c[k, 2] + c[k, 3]
            models.append(E / np.linalg.norm(E))
        out.append(models)
    return out


def sampson_error(E, p1, p2):
    """The EM callback's computeError for models E [M,3,3] on pairs
    [n,2] -> [M,n] float32: (x2^T E x1)^2 / (|(E x1)_xy|^2 +
    |(E^T x2)_xy|^2), in float64, rounded once."""
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=1)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], axis=1)
    Ex1 = np.einsum("mij,nj->mni", E, x1)
    Etx2 = np.einsum("mji,nj->mni", E, x2)
    d = np.einsum("ni,mni->mn", x2, Ex1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return (d * d / (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
                         + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
                ).astype(np.float32)


def find_essential(p1, p2, threshold: float, prob: float = 0.999,
                   max_iters: int = 1000):
    """`cv2.findEssentialMat(p1, p2, focal=1, pp=(0, 0), RANSAC, prob,
    threshold)` on normalized pairs [n,2] -> (E [3,3], inlier mask [n]
    bool), or (None, None) where OpenCV returns no E."""
    p1 = np.asarray(p1, np.float64)[:, :2]
    p2 = np.asarray(p2, np.float64)[:, :2]
    n = p1.shape[0]
    if n < MODEL_POINTS:
        return None, None
    mask, E = ransac.ransac(
        n, MODEL_POINTS, lambda idx: five_point(p1[idx], p2[idx]),
        lambda Es: sampson_error(Es, p1, p2), threshold, prob, max_iters)
    return E, mask


def decompose_essential(E):
    """`cv2.decomposeEssentialMat` -> (R1, R2, t)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2].copy()


def _triangulate(P0, P1, p1, p2):
    """`cv2.triangulatePoints`: per pair the DLT's null vector -> [4,n]."""
    A = np.stack([p1[:, :1] * P0[2] - P0[0], p1[:, 1:2] * P0[2] - P0[1],
                  p2[:, :1] * P1[2] - P1[0], p2[:, 1:2] * P1[2] - P1[1]],
                 axis=1)
    return np.linalg.svd(A)[2][:, 3, :].T


def recover_pose(E, p1, p2, mask=None, distance_thresh: float = 50.0):
    """`cv2.recoverPose(E, p1, p2, focal=1, pp=(0, 0), mask=mask)` ->
    (good count, R [3,3], t [3], cheirality mask [n] bool)."""
    p1 = np.asarray(p1, np.float64)[:, :2]
    p2 = np.asarray(p2, np.float64)[:, :2]
    R1, R2, t = decompose_essential(np.asarray(E, np.float64))
    P0 = np.eye(3, 4)
    cands = [(R1, t), (R2, t), (R1, -t), (R2, -t)]
    masks = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for R, tt in cands:
            P = np.concatenate([R, tt[:, None]], axis=1)
            Q = _triangulate(P0, P, p1, p2)
            m = Q[2] * Q[3] > 0
            Q = Q / Q[3]
            m &= Q[2] < distance_thresh
            Q = P @ Q
            m &= (Q[2] > 0) & (Q[2] < distance_thresh)
            if mask is not None:
                m &= np.asarray(mask, bool).reshape(-1)
            masks.append(m)
    good = [int(m.sum()) for m in masks]
    best = int(np.argmax(good))       # the first of the largest
    R, tt = cands[best]
    return good[best], R, tt, masks[best]


def solve_relative_pose(pts_i, pts_j, focal: float = 460.0,
                        thresh_px: float = 0.3):
    """Relative pose of frame j in frame i from normalized pairs: (R_ij,
    t_ij with |t| = 1, inlier ratio), or None below 15 pairs, without an
    essential matrix, or with fewer than 12 pairs in front."""
    if len(pts_i) < MIN_POINTS:
        return None
    p1 = np.asarray(pts_i, np.float64)[:, :2]
    p2 = np.asarray(pts_j, np.float64)[:, :2]
    E, mask = find_essential(p1, p2, thresh_px / focal)
    if E is None:
        return None
    n_in, R, t, _ = recover_pose(E, p1, p2, mask=mask)
    if n_in < 12:
        return None
    # x2 = R x1 + t: frame j's pose in frame i is (R^T, -R^T t)
    return R.T, -R.T @ t, float(n_in) / len(p1)

