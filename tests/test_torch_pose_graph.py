"""Port parity: the pose-graph solver (`solver/pose_graph.py`) against
the JAX package's, in float64 on the CPU, on tests/test_pose_graph.py's
ring world (odometry with drift and one accurate loop edge).

  * `edge_residual` to 1e-10;
  * `build_normal_equations` (H, b, cost) and `solve` (positions,
    orientations) to 1e-8, the costs to rtol 1e-9, on the ring (K = 24),
    on a capacity-padded ring (64 node slots, 40 valid nodes, invalid
    edge slots) and with a first step whose system is not positive
    definite (a negative initial damping), which both reject.

The padded graph's normal equations are held against JAX's jitted
`build_normal_equations` (what its `solve` runs inside `lax.scan`):
called eagerly, JAX differentiates the norm of an invalid edge's zero
rotation to NaN and multiplies it by the edge's zero weight, so its H
holds NaN there; torch's norm has a zero subgradient at zero. The LM
takes the same accept/reject decisions until the costs tie to the last
bits near convergence; the 1e-8 bound covers a decision that then
differs (CPU run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.solver import pose_graph as jpg
from dynamic_vins_tpu_torch.solver import pose_graph as tpg
from test_pose_graph import _ring_world

torch.set_num_threads(1)   # the xdist workers share the cores

ATOL = 1e-8
COST_RTOL = 1e-9

CASES = {
    "ring": (dict(K=24), {}, {}),
    "padded": (dict(K=40), dict(capacity_nodes=64, capacity_edges=48), {}),
    "non_pd_step": (dict(K=24), {}, dict(init_lambda=-2.0)),
}


def _graphs(case):
    world, cap, cfg = CASES[case]
    init_p, init_q, edges, rels, gt_p, _ = _ring_world(**world)
    gj = jpg.make_graph(init_p, init_q, edges, rels, **cap)
    gt = tpg.make_graph(init_p, init_q, edges, rels, device="cpu", **cap)
    return gj, gt, jpg.PgoConfig(**cfg), tpg.PgoConfig(**cfg), gt_p


def test_edge_residual_matches_jax():
    gj, gt, _, _, _ = _graphs("ring")
    rng = np.random.default_rng(0)
    i, j = np.asarray(gj.edge_i), np.asarray(gj.edge_j)
    # perturbed nodes and a full sqrt-information
    dp = rng.normal(scale=0.1, size=(len(i), 2, 3))
    L = np.tril(rng.normal(size=(len(i), 6, 6))) + 3 * np.eye(6)
    args = [np.asarray(gj.p)[i] + dp[:, 0], np.asarray(gj.q)[i],
            np.asarray(gj.p)[j] + dp[:, 1], np.asarray(gj.q)[j],
            np.asarray(gj.rel_p), np.asarray(gj.rel_q), L]
    rj = jax.vmap(jpg.edge_residual)(*map(jnp.asarray, args))
    rt = tpg.edge_residual(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_normal_equations_match_jax(case):
    gj, gt, cj, ct, _ = _graphs(case)
    Hj, bj, costj, freej = jax.jit(jpg.build_normal_equations,
                                   static_argnums=1)(gj, cj)
    Ht, bt, costt, freet = tpg.build_normal_equations(gt, ct)
    np.testing.assert_array_equal(freet.numpy(), np.asarray(freej))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(costt), float(costj), rtol=COST_RTOL)
    if case == "ring":
        # the eager reference agrees where it has no invalid edge
        He = np.asarray(jpg.build_normal_equations(gj, cj)[0])
        np.testing.assert_allclose(Ht.numpy(), He, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax(case):
    gj, gt, cj, ct, _ = _graphs(case)
    oj, ij = jpg.solve(gj, cj)
    ot, it = tpg.solve(gt, ct)
    np.testing.assert_allclose(ot.p.numpy(), np.asarray(oj.p), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(ot.q.numpy(), np.asarray(oj.q), rtol=0,
                               atol=ATOL)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]),
                                   rtol=COST_RTOL)
    assert float(it["final_cost"]) < float(it["initial_cost"])


def test_non_pd_step_is_rejected():
    """A factorization that fails gives a NaN step in both, which the
    cost test rejects: one iteration leaves the graph as it was."""
    gj, gt, cj, ct, _ = _graphs("non_pd_step")
    oj, ij = jpg.solve(gj, cj._replace(max_iters=1))
    ot, it = tpg.solve(gt, ct._replace(max_iters=1))
    np.testing.assert_array_equal(ot.p.numpy(), gt.p.numpy())
    np.testing.assert_array_equal(ot.q.numpy(), gt.q.numpy())
    np.testing.assert_array_equal(np.asarray(oj.p), np.asarray(gj.p))
    assert float(it["final_cost"]) == float(it["initial_cost"])
    assert float(ij["final_cost"]) == float(ij["initial_cost"])


def test_pgo_closes_the_loop():
    """tests/test_pose_graph.py's gates on the port."""
    init_p, init_q, edges, rels, gt_p, _ = _ring_world()
    drift0 = np.linalg.norm(init_p[-1] - gt_p[-1])
    assert drift0 > 0.1   # odometry has drifted
    graph = tpg.make_graph(init_p, init_q, edges, rels, device="cpu")
    out, info = tpg.solve(graph)
    assert float(info["final_cost"]) < float(info["initial_cost"])
    err = np.linalg.norm(out.p.numpy()[:len(gt_p)] - gt_p, axis=1)
    assert err.max() < 0.25, err.max()
    init_err = np.linalg.norm(init_p - gt_p, axis=1)
    assert err.max() < init_err.max()


def test_float32_solve_closes_the_loop():
    """float32 (the float type of the card's estimator): the same gates,
    within 1e-4 m of float64 on this small ring."""
    init_p, init_q, edges, rels, gt_p, _ = _ring_world()
    g64 = tpg.make_graph(init_p, init_q, edges, rels, device="cpu")
    g32 = tpg.make_graph(init_p, init_q, edges, rels, device="cpu",
                         dtype=torch.float32)
    o64, _ = tpg.solve(g64)
    o32, info = tpg.solve(g32)
    assert o32.p.dtype == torch.float32
    assert float(info["final_cost"]) < float(info["initial_cost"])
    np.testing.assert_allclose(o32.p.double().numpy(), o64.p.numpy(),
                               rtol=0, atol=1e-4)
