"""Pose-graph optimization (the loop-closure backend) in plain torch,
counterpart of the JAX package's `solver/pose_graph.py`.

SE(3) nodes, relative-pose edges with per-edge sqrt-information, the
residual r_ij = log(T_rel^-1 (T_i^-1 T_j)), Huber-weighted LM with
`torch.func.jacrev` Jacobians vmapped over the edges. The normal
equations are assembled into a dense [6K,6K] system (K poses) by one
scatter of the edge Jacobians and one product, and solved by a
Jacobi-scaled Cholesky. The LM keeps its accept/reject on the device:
`cholesky_ex` does not check, a factor that failed is NaN, and the
step is then rejected by the cost test, as JAX's unchecked
`cho_factor` rejects it. No host read inside `solve`.

In float32 a large graph's solution is only as good as its flat modes
allow: on 512 nodes (two laps of a 20 m ring, 8 loop edges weighted as
the loop closer weighs them) the H100's float32 solve ends 0.43 m from
the CPU's float64 one (`chip_smoke.py` phase 19), so the loop closer
solves in float64 (`loop/closure.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from dynamic_vins_tpu_torch.geometry import lie
from dynamic_vins_tpu_torch.utils.precision import (default_dtype,
                                                    resolve_device)


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph (tensors on one device)."""

    p: torch.Tensor          # [K,3] node positions
    q: torch.Tensor          # [K,4] node orientations
    node_valid: torch.Tensor  # [K] bool
    edge_i: torch.Tensor     # [E] int64
    edge_j: torch.Tensor     # [E]
    rel_p: torch.Tensor      # [E,3] measured T_i^-1 T_j translation
    rel_q: torch.Tensor      # [E,4]
    sqrt_info: torch.Tensor  # [E,6,6]
    edge_valid: torch.Tensor  # [E] bool
    fixed: torch.Tensor      # [K] bool: gauge anchors


class PgoConfig(NamedTuple):
    max_iters: int = 12
    init_lambda: float = 1e-6
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    huber_delta: float = 1.0
    ridge: float = 1e-9


def edge_residual(p_i, q_i, p_j, q_j, rel_p, rel_q, sqrt_info):
    """6-dim whitened relative-pose residual (batched over leading
    axes)."""
    p_ij, q_ij = lie.pose_compose(*lie.pose_inverse(p_i, q_i), p_j, q_j)
    dp = p_ij - rel_p
    dq = lie.quat_log(lie.quat_multiply(lie.quat_conjugate(rel_q), q_ij))
    return (sqrt_info @ torch.cat([dp, dq], -1)[..., None])[..., 0]


def _edge_local(delta, p_i, q_i, p_j, q_j, rel_p, rel_q, sqrt_info):
    """An edge's residual at a tangent perturbation [12] of its nodes."""
    p_i, q_i = lie.pose_boxplus(p_i, q_i, delta[..., :6])
    p_j, q_j = lie.pose_boxplus(p_j, q_j, delta[..., 6:12])
    return edge_residual(p_i, q_i, p_j, q_j, rel_p, rel_q, sqrt_info)


def _edges(graph: PoseGraph):
    """Each edge's two nodes and its measurement, gathered [E,...]."""
    i, j = graph.edge_i, graph.edge_j
    return (graph.p[i], graph.q[i], graph.p[j], graph.q[j], graph.rel_p,
            graph.rel_q, graph.sqrt_info)


def _residuals(graph: PoseGraph):
    args = _edges(graph)
    zero = torch.zeros(graph.edge_i.shape[0], 12, dtype=graph.p.dtype,
                       device=graph.p.device)
    return _edge_local(zero, *args), zero, args


def _cost(r, valid):
    return 0.5 * torch.sum(torch.sum(r * r, dim=-1) * valid)


def graph_cost(graph: PoseGraph):
    """0.5 * the sum of the valid edges' squared residuals (unweighted)."""
    return _cost(_residuals(graph)[0], graph.edge_valid)


def build_normal_equations(graph: PoseGraph, config: PgoConfig):
    """Dense [6K,6K] GN system from all edges: (H, b, cost, free)."""
    K = graph.p.shape[0]
    E = graph.edge_i.shape[0]
    D = 6 * K
    dtype, dev = graph.p.dtype, graph.p.device
    r, zero, args = _residuals(graph)
    J = vmap(jacrev(_edge_local))(zero, *args)           # [E,6,12]
    valid = graph.edge_valid
    # Huber
    r2 = torch.sum(r * r, dim=-1)
    w = torch.where(r2 <= config.huber_delta ** 2, 1.0,
                    torch.sqrt(config.huber_delta
                               / torch.sqrt(torch.clamp_min(r2, 1e-18))))
    w = torch.where(valid, w, 0.0)
    cost = _cost(r, valid)
    r = r * w[:, None]
    J = J * w[:, None, None]

    base = torch.arange(6, device=dev)
    cols = torch.cat([6 * graph.edge_i[:, None] + base[None, :],
                      6 * graph.edge_j[:, None] + base[None, :]], dim=1)
    rows = (torch.arange(E, device=dev)[:, None, None] * 6
            + base[None, :, None]).expand(E, 6, 12)
    Jd = torch.zeros(E * 6, D, dtype=dtype, device=dev)
    Jd.index_put_((rows, cols[:, None, :].expand(E, 6, 12)), J,
                  accumulate=True)
    rf = r.reshape(E * 6)
    # gauge: zero columns of fixed nodes
    free = ~torch.repeat_interleave(graph.fixed, 6)
    Jd = Jd * free[None, :].to(dtype)
    return Jd.T @ Jd, Jd.T @ rf, cost, free


def _cho_solve(A, b):
    """A^-1 b by Cholesky, NaN where the factorization failed."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where(info == 0, L, float("nan"))
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


def solve(graph: PoseGraph, config: PgoConfig = PgoConfig()):
    """LM over the whole graph; returns (graph, {"initial_cost",
    "final_cost"}) with 0-d tensors."""
    K = graph.p.shape[0]
    g = graph
    cost = init_cost = graph_cost(g)
    lam = torch.tensor(config.init_lambda, dtype=graph.p.dtype,
                       device=graph.p.device)
    for _ in range(config.max_iters):
        H, b, _, free = build_normal_equations(g, config)
        diag = torch.diagonal(H)
        damped = diag * (1.0 + lam) + config.ridge
        damped = torch.where(free & (diag > 0), damped, 1.0)
        H = H + torch.diag(damped - diag)
        scale = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(H), 1e-18))
        Hs = H * scale[:, None] * scale[None, :]
        delta = -scale * _cho_solve(Hs, scale * b)
        delta = torch.where(free, delta, 0.0).reshape(K, 6)
        p2, q2 = lie.pose_boxplus(g.p, g.q, delta)
        new_cost = graph_cost(g._replace(p=p2, q=q2))
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        lam = torch.clamp(torch.where(accept, lam * config.lambda_down,
                                      lam * config.lambda_up), 1e-12, 1e10)
        g = g._replace(p=torch.where(accept, p2, g.p),
                       q=torch.where(accept, q2, g.q))
        cost = torch.where(accept, new_cost, cost)
    return g, {"initial_cost": init_cost, "final_cost": cost}


def make_graph(positions, quats, edges, rel_poses, capacity_nodes=None,
               capacity_edges=None, info_scale=1.0, fixed_nodes=(0,),
               dtype=None, device=None):
    """Host helper: a fixed-capacity PoseGraph on `device` (the card
    unless the CPU is asked for) in `dtype` (the device's default)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    K = len(positions)
    E = len(edges)
    Kc = capacity_nodes or K
    Ec = capacity_edges or E
    p = np.zeros((Kc, 3))
    p[:K] = np.asarray(positions)
    q = np.tile([1.0, 0, 0, 0], (Kc, 1))
    q[:K] = np.asarray(quats)
    nv = np.zeros(Kc, bool)
    nv[:K] = True
    ei = np.zeros(Ec, np.int64)
    ej = np.zeros(Ec, np.int64)
    rp = np.zeros((Ec, 3))
    rq = np.tile([1.0, 0, 0, 0], (Ec, 1))
    si = np.tile(np.eye(6) * info_scale, (Ec, 1, 1))
    ev = np.zeros(Ec, bool)
    for k, ((i, j), (tp, tq)) in enumerate(zip(edges, rel_poses)):
        ei[k], ej[k] = i, j
        rp[k] = np.asarray(tp)
        rq[k] = np.asarray(tq)
        ev[k] = True
    fixed = np.zeros(Kc, bool)
    fixed[list(fixed_nodes)] = True
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, device=device)
    return PoseGraph(f(p), f(q), t(nv), t(ei), t(ej), f(rp), f(rq), f(si),
                     t(ev), t(fixed))
