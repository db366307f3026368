"""The port stands alone: importing it (and every module in it) loads
neither JAX nor the JAX package, nor OpenCV, PyYAML or PIL (the port
runs where none of them is installed), and no source of the port or of
chip_smoke.py names them in an import. The PNG decoder's C source
builds from the repository alone, into its build directory.

The import check runs in a subprocess: this test process already has
JAX loaded by the repository's conftest."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dynamic_vins_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "dynamic_vins_tpu", "cv2", "yaml",
          "PIL")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")


def test_scan_covers_every_module():
    """The scans below reach the DYNAMIC slice's modules, the mono
    initialization's, LinePoint's, the perception nets' and their
    training's, the loggers, planar calibration, feature record/replay,
    the prefetching loader and the bench-side tools too."""
    mods = set(_port_modules())
    for m in ("mot.kalman", "mot.tracker", "io.perception", "io.writers",
              "sim.dynamic_scene", "sim.render", "estimator.box_fit",
              "estimator.host_math", "estimator.instance_manager",
              "factors.object_factors", "solver.object_solver",
              "frontend.instance_tracker", "convert", "system", "run",
              "io.image_io", "io.datasets", "io.evaluation",
              "io.eval_tools", "frontend.ransac", "estimator.essential",
              "estimator.initializer", "estimator.ex_rotation",
              "sim.ba_problems", "sim.objects", "frontend.lsd",
              "frontend.line_tracker", "geometry.lines",
              "factors.line_factor", "estimator.line_manager",
              "models.layers", "models.pretrained", "models.raft",
              "models.stereo_net", "models.solov2", "models.det3d",
              "models.reid", "training.data", "training.losses",
              "training.trainer", "training.cli",
              "tools.train_shipped_weights", "tools.precompute",
              "utils.logging", "geometry.calibration",
              "io.feature_serialization", "io.native_loader",
              "tools.accuracy_probe", "tools.dynamic_bench",
              "tools.singlechip_scaling", "tools.build_engines"):
        assert f"dynamic_vins_tpu_torch.{m}" in mods, m


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "import dynamic_vins_tpu_torch\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_models_import_loads_no_jax():
    """The perception nets, their weights loader, generators, training
    CLI and tools import neither JAX nor flax nor the JAX package (they
    read its shipped `.npz` files by path); the training CLI parses its
    arguments and builds a task without them."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import dynamic_vins_tpu_torch.models as m\n"
        "from dynamic_vins_tpu_torch.models import (det3d, layers, "
        "pretrained, raft, reid, solov2, stereo_net)\n"
        "from dynamic_vins_tpu_torch.training import cli, data\n"
        "from dynamic_vins_tpu_torch.tools import (precompute, "
        "train_shipped_weights)\n"
        "assert pretrained.weights_path('solo')\n"
        "cli.build_task('reid', (64, 32), np.random.default_rng(0), 8, "
        "'cpu')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dynamic_vins_tpu'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_nothing_banned(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in BANNED, f"{path}:{node.lineno} {name}"


def test_cli_import_loads_no_decoder_library():
    """The CLI and its readers, the prefetching loader and the tools
    import without OpenCV, PyYAML or PIL."""
    code = ("import sys\n"
            "import dynamic_vins_tpu_torch.run\n"
            "import dynamic_vins_tpu_torch.io.native_loader\n"
            "from dynamic_vins_tpu_torch.tools import (accuracy_probe, "
            "build_engines, dynamic_bench, singlechip_scaling)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'yaml', 'PIL'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_png_unfilter_builds_from_the_repo():
    from dynamic_vins_tpu_torch.ops import build

    src, _ = build._source("png_unfilter")
    assert src == PORT / "csrc" / "png_unfilter.c"
    out = build.build("png_unfilter")
    assert out == build.library_path("png_unfilter")
    assert out.parent == REPO / "build" / "kernels" and out.exists()
    # nothing outside the repository: the source includes only the C
    # library's headers
    includes = [l for l in src.read_text().splitlines()
                if l.startswith("#include")]
    assert includes == ["#include <stdint.h>", "#include <stdlib.h>",
                        "#include <string.h>"]
