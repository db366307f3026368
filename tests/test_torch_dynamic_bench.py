"""Port parity: the DYNAMIC bench (`tools/dynamic_bench`).

The JAX tool (`python -m dynamic_vins_tpu.tools.dynamic_bench`) and the
port's, both at `--frames 14 --window 6 --cpu` in float64 (the JAX
side through tests/conftest.py's x64, the port's by `--dtype
float64`): the ego ATE and every object's position and velocity error
equal at their printed rounding, and the same objects reported.

Both run with `utils.prefetch.AsyncFetch.ready` joining the fetch
thread, as the parity tests run it: the JAX package applies an object
solve once its thread has finished, so its object states follow thread
timing, and the port applies each at the first read (ROADMAP.md). Both
are cut the same way to fit the test budget: 14 frames (the window of 6
slides eight times, both objects are initialized and solved), 1024
observation rows, 256 landmark slots and 2 object slots. Most of the
JAX side's time is tracing and compiling its estimator, which its tool
drives twice (warm-up, then timed).
"""

import json
import sys

import numpy as np
import torch

from dynamic_vins_tpu.estimator import estimator as jest
from dynamic_vins_tpu.estimator import instance_manager as jim
from dynamic_vins_tpu.tools import dynamic_bench as jdb
from dynamic_vins_tpu.utils import prefetch
from dynamic_vins_tpu_torch.estimator import estimator as test_
from dynamic_vins_tpu_torch.estimator import instance_manager as tim
from dynamic_vins_tpu_torch.tools import dynamic_bench as tdb

torch.set_num_threads(1)   # the xdist workers share the cores

ARGS = ["--frames", "14", "--window", "6", "--cpu"]


def _landed(self):
    """AsyncFetch.ready for the parity runs: wait for the fetch."""
    self._thread.join()
    return True


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dynamic_bench_matches(monkeypatch, capsys):
    monkeypatch.setattr(prefetch.AsyncFetch, "ready", _landed)
    for est, inst in ((jest, jim), (test_, tim)):
        cfg, icfg = est.EstimatorConfig, inst.InstanceConfig
        monkeypatch.setattr(est, "EstimatorConfig",
                            lambda *a, _cfg=cfg, **k: _cfg(
                                *a, **{**k, "obs_capacity": 1024,
                                       "lm_capacity": 256}))
        monkeypatch.setattr(inst, "InstanceConfig",
                            lambda *a, _icfg=icfg, **k: _icfg(
                                *a, **{**k, "max_objects": 2}))
    monkeypatch.setattr(sys, "argv", ["dynamic_bench", *ARGS])
    jdb.main()
    ref = _line(capsys)["detail"]
    assert tdb.main([*ARGS, "--dtype", "float64"]) == 0
    line = _line(capsys)
    d = line["detail"]
    assert line["metric"] == "dynamic_e2e_ms_per_frame"
    assert d["device"] == "cpu" and d["frames"] == 14 and d["objects"] == 2
    assert np.isfinite([line["value"], d["mean_ms"], d["p90_ms"]]).all()
    # equal at the printed rounding (one unit of the last place)
    assert abs(d["ego_ate_m"] - ref["ego_ate_m"]) <= 1e-4, (d, ref)
    assert len(ref["objects_err"]) == 2
    assert d["objects_err"].keys() == ref["objects_err"].keys()
    for tid, r in ref["objects_err"].items():
        for k, v in r.items():
            assert abs(d["objects_err"][tid][k] - v) <= 1e-3, (tid, k)
