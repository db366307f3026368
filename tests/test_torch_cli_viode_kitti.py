"""The port's CLI against the JAX package's on the VIODE NAIVE and the
sequential KITTI DYNAMIC fixture trees: the cases, fixtures and gates
of tests/test_torch_cli.py (see its docstring), split off so the two
halves run in two xdist workers."""

import pytest
import torch

from test_torch_cli import CASES, HERE, check_case

torch.set_num_threads(1)   # the xdist workers share the cores


@pytest.mark.parametrize("case", [c for c in CASES if c not in HERE])
def test_cli_matches_jax(tmp_path, monkeypatch, case, capsys):
    check_case(tmp_path, monkeypatch, case, capsys)
