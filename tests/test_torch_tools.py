"""Port parity: the accuracy probe (`tools/accuracy_probe`), the bench's
end-to-end protocol, in float64 on the CPU: the JAX package's own
`run_protocol([0])` and the port's on the same cut protocol, the aligned
and unaligned ATE within 1e-6 m, the per-seed line equal.

To fit the test budget both packages' protocol is cut the same way:
`generate_sequence` to 14 frames (the window of 11 fills and slides
three times; the card runs the full 42 in chip_smoke.py phase 21a) and
the estimator to 1024 observation rows and 256 landmark slots instead
of 8192 and 512 (the scene has ~46 features a frame). Most of the
JAX side's time is compiling its estimator."""

import json

import pytest
import torch

from dynamic_vins_tpu.estimator import estimator as jest
from dynamic_vins_tpu.sim import synthetic as jsim
from dynamic_vins_tpu.tools import accuracy_probe as jap
from dynamic_vins_tpu_torch.estimator import estimator as test_
from dynamic_vins_tpu_torch.sim import synthetic as tsim
from dynamic_vins_tpu_torch.tools import accuracy_probe as tap

torch.set_num_threads(1)   # the xdist workers share the cores

FRAMES = 14


def _cut(monkeypatch):
    for sim, est in ((jsim, jest), (tsim, test_)):
        gen, cfg = sim.generate_sequence, est.EstimatorConfig
        monkeypatch.setattr(sim, "generate_sequence",
                            lambda *a, _gen=gen, **k: _gen(
                                *a, **{**k, "num_frames": FRAMES}))
        monkeypatch.setattr(est, "EstimatorConfig",
                            lambda *a, _cfg=cfg, **k: _cfg(
                                *a, **{**k, "obs_capacity": 1024,
                                       "lm_capacity": 256}))


def test_protocol_matches(monkeypatch, capsys):
    _cut(monkeypatch)
    j = jap.run_protocol([0])
    t = tap.run_protocol([0], dtype=torch.float64, device="cpu")
    assert abs(t[0] - j[0]) < 1e-6 and abs(t[1] - j[1]) < 1e-6, (t, j)
    assert t[2] == j[2]
    assert 0 < t[0] < 0.06          # tests/test_estimator_e2e.py's gate

    # the tool's JSON line, with its protocol's numbers
    monkeypatch.setattr(tap, "run_protocol", lambda seeds, **k: t)
    assert tap.main(["--platform", "cpu", "--x64"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"ate_aligned": round(t[0], 4),
                    "ate_raw": round(t[1], 4), "per_seed": t[2],
                    "x64": True}


def test_defaults_to_the_card(monkeypatch):
    """Without a card the tool refuses rather than measure the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tap.main([])
