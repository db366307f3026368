"""Port parity: the exported perception stages (`tools/build_engines`,
`torch.export`). The ReID stage's artifact calls as the live function
does (atol 1e-5, as tests/test_tools.py:91 asks of the JAX artifact),
and the port's engine equals the JAX package's `jax.export` engine on
the shipped weights within 1e-4 of the output's scale; a stage that
does not export raises and writes nothing; the CLI writes `<task>.pt2`."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_vins_tpu.tools import build_engines as jbe
from dynamic_vins_tpu_torch.tools import build_engines as tbe

torch.set_num_threads(1)   # the xdist workers share the cores


def test_reid_export_roundtrip_and_parity(tmp_path):
    fn, params, inputs = tbe.stage_fn("reid", None, device="cpu")
    path = tbe.export_stage("reid", None, str(tmp_path / "port"),
                            device="cpu")
    assert path.endswith("reid.pt2") and os.path.getsize(path) > 0
    engine = tbe.load_engine(path)
    x = np.random.default_rng(0).normal(0, 1, tuple(inputs[0].shape)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        live = fn(params, xt).numpy()
        aot = engine(params, xt).numpy()
    np.testing.assert_allclose(aot, live, atol=1e-5)

    jpath = jbe.export_stage("reid", None, str(tmp_path / "jax"))
    _, jparams, _ = jbe.stage_fn("reid", None)
    ref = np.asarray(jbe.load_engine(jpath)(jparams, jnp.asarray(x)))
    assert aot.shape == ref.shape
    np.testing.assert_allclose(aot, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_unexportable_stage_raises(tmp_path, monkeypatch):
    """A host sync inside the stage: export raises, no file is kept."""
    def stage_fn(task, image_hw, intrinsics=None, device=None):
        def fn(p, x):
            return x * 2 if float(x.sum()) > 0 else x
        return fn, {}, [torch.ones(3)]

    monkeypatch.setattr(tbe, "stage_fn", stage_fn)
    with pytest.raises(Exception):
        tbe.export_stage("reid", None, str(tmp_path), device="cpu")
    assert not os.path.exists(tmp_path / "reid.pt2")


def test_cli_writes_engines(tmp_path, capsys):
    assert tbe.main(["--out", str(tmp_path), "--tasks", "reid", "--warm",
                     "--cpu"]) == 0
    assert os.path.getsize(tmp_path / "reid.pt2") > 0
    assert "reid: exported" in capsys.readouterr().out
