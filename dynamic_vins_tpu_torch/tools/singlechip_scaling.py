"""One card's scaling curve for the window LM, and a projection to N
cards.

What one card can measure:
  1. the solve's time against the problem's size (observation rows,
     landmark slots): how the work scales, and where the launch floor
     sits;
  2. batched windows (B window solves at once): what partitioning many
     windows over cards amortizes, since one window leaves the card
     latency-bound;
  3. a model of the reduction a distributed solve adds: it reduces the
     camera-block normal equations (S x S + S floats, S = 15 F + 6 + 12
     + 1 columns) once an LM iteration; with the measured compute an
     iteration this projects the efficiency on N cards over the link.

The solve is `solver/gauss_newton.solve` (10 LM iterations, IMU on) in
float32 with TF32 off, on the 11-frame synthetic problems of
`sim/ba_problems`. On the card each configuration is captured once as
a CUDA graph (`utils/step_graph.StepGraph`, the counterpart of a
compiled program) and timed by replays: R back-to-back, one
`torch.cuda.synchronize()`, the minimum over M rounds. The batched
windows are `torch.func.vmap` of `solve`, captured as one graph; each
row says so in `how`.

The link rate is the H100 SXM5's published NVLink 4 figure, 450 GB/s in
each direction (900 GB/s total); one card cannot measure a link, so
the model's communication time is a projection from that published
figure, not a measurement.

    python -m dynamic_vins_tpu_torch.tools.singlechip_scaling [--fast]
        [--out FILE] [--cpu]

Prints one JSON document.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ITERS = 10
# H100 SXM5, NVLink 4: 18 links, 900 GB/s total, 450 GB/s each
# direction (NVIDIA's published figure)
NVLINK_BYTES_S = 4.5e11
LINK = "NVLink 4 (H100 SXM5), 450 GB/s each direction, published"
BATCHED_HOW = {"cuda": "torch.func.vmap of solve, one CUDA graph",
               "cpu": "torch.func.vmap of solve, eager"}


def state_cols(num_frames: int = 11) -> int:
    """Columns of the camera block the distributed solve reduces: pose,
    velocity and biases of each frame, the two extrinsics, td."""
    return int(15 * num_frames + 6 + 12 + 1)


def psum_model(obs_sweep, link_bytes_s: float = NVLINK_BYTES_S,
               iters: int = ITERS, obs_ref: int = 8192) -> dict:
    """The reduction model from the obs-row sweep's rows ({"obs_rows",
    "ms_10iter"}): bytes reduced an iteration, their time over the link,
    the compute an iteration of the `obs_ref`-row solve, the serial
    fraction from a linear fit t(obs) = a + b obs (the intercept stays
    replicated under sharding; the slope shards), and the projected ms
    an iteration and efficiency on 2, 4 and 8 cards."""
    S = state_cols()
    bytes_per_iter = (S * S + S + 2) * 4
    ms_ref = next(r["ms_10iter"] for r in obs_sweep
                  if r["obs_rows"] == obs_ref)
    compute_per_iter_ms = ms_ref / iters
    comm_ms = bytes_per_iter / link_bytes_s * 1000
    xs = np.array([r["obs_rows"] for r in obs_sweep], float)
    ys = np.array([r["ms_10iter"] for r in obs_sweep], float)
    b_fit, a_fit = np.polyfit(xs, ys, 1)
    serial_frac = float(np.clip(a_fit / ms_ref, 0.05, 0.95))
    proj = []
    for n in (2, 4, 8):
        t_n = compute_per_iter_ms * (serial_frac
                                     + (1 - serial_frac) / n) + comm_ms
        proj.append({"devices": n,
                     "projected_ms_per_iter": round(t_n, 3),
                     "projected_efficiency": round(
                         compute_per_iter_ms / (n * t_n), 3)})
    ratio = comm_ms / compute_per_iter_ms
    bound = "the serial fraction (the replicated Schur solve)" \
        if ratio < 0.1 * (1 - serial_frac) else "the link"
    return {
        "state_cols": S, "psum_bytes_per_iter": bytes_per_iter,
        "link_bytes_per_s": link_bytes_s,
        "comm_ms_per_iter_link": round(comm_ms, 5),
        "compute_ms_per_iter_1chip": round(compute_per_iter_ms, 3),
        "serial_frac_measured": round(serial_frac, 3),
        "note": f"comm is {ratio:.1e} of compute an iteration; the "
                f"projection is bound by {bound}",
        "projection": proj}


def _cast(tree, dtype, device):
    from torch.utils import _pytree as pytree

    def one(a):
        if not hasattr(a, "dtype"):
            return a
        return a.to(device=device, dtype=dtype if a.is_floating_point()
                    else a.dtype)

    return pytree.tree_map(one, tree)


def build(obs: int, lm_cap: int, n_lm: int, device, dtype=None):
    """(state0, inv_depth0, problem): the 11-frame problem built in
    float64, perturbed (0.05 m, 0.02 rad), cast to `dtype` (float32) on
    `device`."""
    import torch

    from dynamic_vins_tpu_torch.sim import ba_problems

    dtype = dtype or torch.float32
    ba = ba_problems.build(num_frames=11, num_landmarks=n_lm,
                           obs_capacity=obs, lm_capacity=lm_cap,
                           pixel_noise=0.5, seed=0)
    state0 = ba_problems.perturb_state(ba.gt_state, pos_sigma=0.05,
                                       rot_sigma=0.02, seed=1)
    return (_cast(state0, dtype, device), _cast(ba.gt_inv_depth, dtype,
                                                device),
            _cast(ba.problem, dtype, device))


class Solver:
    """`fn(state, inv_depth, problem)` on fixed inputs: a CUDA graph
    replay on the card (captured at the first call), eager on the
    CPU."""

    def __init__(self, fn, args, device):
        import torch
        from torch.utils import _pytree as pytree

        from dynamic_vins_tpu_torch.utils.step_graph import StepGraph

        self.device = torch.device(device)
        # the graph's static inputs are the tensors alone (a problem
        # without lines holds None fields)
        leaves, spec = pytree.tree_flatten(args)
        where = [i for i, a in enumerate(leaves)
                 if isinstance(a, torch.Tensor)]

        def step(key, tensors):
            full = list(leaves)
            for i, t in zip(where, tensors):
                full[i] = t
            return fn(*pytree.tree_unflatten(full, spec))

        self.graph = StepGraph(step, self.device)
        self.tensors = tuple(leaves[i] for i in where)

    def __call__(self):
        if self.graph.on_card and self.graph.inputs is not None:
            return self.graph.replay(0)
        return self.graph(0, self.tensors)


def _queued_ms(solver, R=6, M=3):
    """R back-to-back calls, one synchronize; the minimum over M rounds
    (ms a call)."""
    import torch

    on_card = solver.device.type == "cuda"
    best = np.inf
    for _ in range(M):
        t0 = time.perf_counter()
        for _ in range(R):
            solver()
        if on_card:
            torch.cuda.synchronize(solver.device)
        best = min(best, (time.perf_counter() - t0) / R)
    return best * 1000.0


def _stack(tree, B):
    import torch
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda a: torch.stack([a] * B) if hasattr(a, "dtype") else a, tree)


def _max_diff(a, b) -> float:
    """Largest |a - b| over two states' matching leaves (in float64; a
    batched leaf against an unbatched one broadcasts)."""
    from torch.utils import _pytree as pytree

    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _batched(solve, args, Bs, device, single, timed=True, ref64=None):
    """A row for each B: the vmapped solve of B copies of `args`, its
    time (`timed`), and the largest difference of its windows' states
    from the B = 1 row's (`max_state_diff`), from `single`, the
    unbatched solve's state (`max_diff_unbatched`), and from `ref64`,
    the float64 solve of the same inputs (`max_diff_f64`), if given."""
    import torch
    from torch.utils import _pytree as pytree

    in_dims = tuple(pytree.tree_map(
        lambda a: 0 if isinstance(a, torch.Tensor) else None, a)
        for a in args)
    vsolve = torch.func.vmap(solve, in_dims=in_dims)
    rows, ref = [], None
    # batched Cholesky calls through cuSOLVER: MAGMA's batched solves
    # cannot be captured (they synchronize)
    lib = torch.backends.cuda.preferred_linalg_library()
    if device.type == "cuda":
        torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        for B in Bs:
            solver = Solver(vsolve, tuple(_stack(a, B) for a in args),
                            device)
            st, _, info = solver()
            costs = info.final_cost.cpu().numpy()
            if not np.all(np.isfinite(costs)):
                raise RuntimeError(f"non-finite batched final costs {costs}")
            st = pytree.tree_map(lambda a: a.clone(), st)
            if ref is None:             # the B = 1 row
                ref = pytree.tree_map(lambda a: a[0], st)
            row = {"windows": B}
            if timed:
                ms = _queued_ms(solver)
                row.update(ms_10iter=round(ms, 2),
                           windows_per_s=round(B / ms * 1000, 1),
                           window_iters_per_s=round(B * ITERS / ms * 1000,
                                                    1))
            row.update(max_state_diff=_max_diff(st, ref),
                       max_diff_unbatched=_max_diff(st, single))
            if ref64 is not None:
                row["max_diff_f64"] = _max_diff(st, ref64)
            row["how"] = (f"{BATCHED_HOW[device.type]}, "
                          f"{str(args[1].dtype)[6:]}")
            rows.append(row)
    finally:
        if device.type == "cuda":
            torch.backends.cuda.preferred_linalg_library(lib)
    return rows


def run(fast: bool = False, device=None) -> dict:
    """The scaling document (see the module docstring). Every final cost
    must be finite. Each batched row gives the largest difference of its
    windows' states from the B = 1 row's (`max_state_diff`), from the
    unbatched solve's (`max_diff_unbatched`) and from the float64 solve
    of the same inputs (`max_diff_f64`); `f32_unbatched_vs_f64` is the
    unbatched float32 solve's own distance from that float64 solve;
    `batched_check_f64` gives the first two for the largest B in
    float64."""
    import torch

    from torch.utils import _pytree as pytree

    from dynamic_vins_tpu_torch.solver import gauss_newton as gn
    from dynamic_vins_tpu_torch.utils.precision import resolve_device

    device = resolve_device(device)
    cfg = gn.SolverConfig(use_imu=True, max_iters=ITERS)
    solve = lambda s, d, p: gn.solve(s, d, p, cfg)
    out = {"device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu", "iters": ITERS}

    def measure(args):
        solver = Solver(solve, args, device)
        st, _, info = solver()
        st = pytree.tree_map(lambda a: a.clone(), st)
        cost = float(info.final_cost)
        if not np.isfinite(cost):
            raise RuntimeError(f"non-finite final cost {cost}")
        return solver, st, cost

    rows = []
    for obs in ([2048, 8192, 32768] if fast else
                [2048, 4096, 8192, 16384, 32768]):
        # the static obs capacity drives the cost (padded tables): the
        # fill fraction stays near 4.1 rows a landmark
        solver, _, cost = measure(build(obs, 1024, min(900, obs // 5),
                                        device))
        ms = _queued_ms(solver)
        rows.append({"obs_rows": obs, "ms_10iter": round(ms, 2),
                     "iter_per_s": round(ITERS / ms * 1000, 1),
                     "final_cost": cost})
    out["obs_sweep"] = rows

    rows = []
    for lm_cap in ([256, 4096] if fast else [256, 512, 1024, 2048, 4096]):
        solver, _, cost = measure(build(8192, lm_cap, min(900, lm_cap - 64),
                                        device))
        rows.append({"lm_slots": lm_cap,
                     "ms_10iter": round(_queued_ms(solver), 2),
                     "final_cost": cost})
    out["lm_sweep"] = rows

    Bs = [1, 4] if fast else [1, 2, 4, 8]
    args = build(8192, 1024, 900, device)
    _, single, _ = measure(args)
    # float32's own rounding: the unbatched float32 solve against the
    # float64 solve of the same (float32) inputs, the yardstick for the
    # float32 batched rows' distances
    _, ref64, _ = measure(_cast(args, torch.float64, device))
    out["f32_unbatched_vs_f64"] = _max_diff(single, ref64)
    out["batched_windows"] = _batched(solve, args, Bs, device, single,
                                      ref64=ref64)
    # the same batched program in float64: the batching itself against
    # B = 1, with float32's rounding out of the way
    args64 = build(8192, 1024, 900, device, dtype=torch.float64)
    _, single64, _ = measure(args64)
    chk = _batched(solve, args64, [1, Bs[-1]], device, single64,
                   timed=False)[-1]
    out["batched_check_f64"] = {k: chk[k] for k in (
        "windows", "max_state_diff", "max_diff_unbatched", "how")}
    out["psum_model"] = psum_model(out["obs_sweep"])
    out["link"] = LINK
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    res = run(fast=args.fast, device="cpu" if args.cpu else None)
    s = json.dumps(res, indent=1)
    print(s, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
