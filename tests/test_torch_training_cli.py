"""Port parity for the training CLI and the weights tool
(`training/cli.py`, `tools/train_shipped_weights.py`): a checkpoint
the port's `main --cpu` writes loads in the JAX package's `load_params`
with exactly its key set and equal values; `--resume` crosses between
the packages in both directions (the resumed runs print the same
losses: the same parameters on the same batches, float32, 2e-4
relative, the losses printed to 4 decimals); the weights tool at a tiny
`--scale` writes the shipped `MANIFEST.json`'s fields and float16
files of the shipped files' keys and shapes, which `load_online(
params_path=)` reads, and refuses a directory inside the JAX package.
"""

import json
import re

import numpy as np
import pytest
import torch

from dynamic_vins_tpu.models import pretrained as jpre
from dynamic_vins_tpu.models.solov2 import load_params
from dynamic_vins_tpu.training import cli as jcli
from dynamic_vins_tpu_torch.models import pretrained as tpre
from dynamic_vins_tpu_torch.tools import train_shipped_weights as tool
from dynamic_vins_tpu_torch.training import cli as tcli
from test_torch_models import flat, jit_flax_init  # noqa: F401 (autouse)

torch.set_num_threads(1)   # the xdist workers share the cores

SMALL = ["--task", "stereo", "--hw", "32", "64", "--batch", "2",
         "--log-every", "1"]


def losses(out):
    return [float(v) for v in re.findall(r"loss (\S+)", out)]


def run(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return losses(capsys.readouterr().out)


def test_checkpoints_and_resume_cross_packages(tmp_path, capsys):
    port_ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    run(tcli.main, SMALL + ["--steps", "2", "--cpu", "--out", port_ck],
        capsys)
    # the JAX package loads it with exactly its tree's keys
    template, _, _ = jcli.build_task("stereo", (32, 64),
                                     np.random.default_rng(0), 2)
    with np.load(port_ck) as f:
        saved = {k: f[k] for k in f.files}
    assert set(saved) == set(flat(template))
    for k, v in flat(load_params(template, port_ck)).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    # --resume: JAX from the port's file, the port from it too
    lj = run(jcli.main, SMALL + ["--steps", "2", "--resume", port_ck,
                                 "--out", jax_ck], capsys)
    lt = run(tcli.main, SMALL + ["--steps", "2", "--resume", port_ck,
                                 "--cpu"], capsys)
    assert len(lj) == len(lt) == 2
    np.testing.assert_allclose(lt, lj, rtol=2e-4)
    # and the port from JAX's file, against JAX from its own
    lj = run(jcli.main, SMALL + ["--steps", "1", "--resume", jax_ck],
             capsys)
    lt = run(tcli.main, SMALL + ["--steps", "1", "--resume", jax_ck,
                                 "--cpu"], capsys)
    np.testing.assert_allclose(lt, lj, rtol=2e-4)


def test_data_parallel_flag_runs_one_device(capsys):
    lt = run(tcli.main, SMALL + ["--steps", "1", "--cpu",
                                 "--data-parallel"], capsys)
    assert len(lt) == 1 and np.isfinite(lt[0])


def test_train_shipped_weights_tiny(tmp_path, capsys):
    out = tmp_path / "weights"
    assert tool.main(["--scale", "0.001", "--cpu", "--out-dir",
                      str(out)]) == 0
    shipped = jpre.manifest()
    with open(out / "MANIFEST.json") as f:
        made = json.load(f)
    assert made.keys() == shipped.keys() == tool.RECIPES.keys()
    for task, entry in made.items():
        ref = shipped[task]
        assert entry.keys() == ref.keys()
        assert entry["file"] == ref["file"] and \
            entry["model"] == ref["model"]
        assert entry["trained"].keys() == ref["trained"].keys()
        _, steps, batch, lr = tool.RECIPES[task]
        assert entry["trained"]["steps"] == 2
        assert (entry["trained"]["batch"], entry["trained"]["lr"]) == \
            (batch, lr) == (ref["trained"]["batch"], ref["trained"]["lr"])
        assert entry["trained"]["data"] == ref["trained"]["data"]
        with np.load(out / entry["file"]) as got, \
                np.load(jpre.weights_path(task)) as want:
            assert set(got.files) == set(want.files)
            for k in want.files:
                assert got[k].shape == want[k].shape
                assert got[k].dtype == want[k].dtype == np.float16
        tpre.load_online(task, (64, 96), [100.0, 100.0, 48.0, 32.0],
                         device="cpu", params_path=str(out / entry["file"]))
    with pytest.raises(SystemExit, match="JAX package"):
        tool.main(["--tasks", "reid", "--cpu", "--out-dir",
                   str(tpre.WEIGHTS_DIR)])
