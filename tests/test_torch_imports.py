"""The PyTorch port never imports JAX or the JAX package.

An AST check of every module of ``primitive3d_tpu_torch``, of the port's
examples (``examples/torch/``), of ``chip_smoke.py``,
``tools/torch_kernel_ab.py`` and the card tests' helpers
(``tests/mask_cases.py``, ``tests/stream_cases.py``): no ``import jax``,
``jaxlib`` or ``primitive3d_tpu`` (relative imports stay inside the port).
A check of ``sys.modules`` cannot work here, because the test process
imports JAX for the parity tests.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "primitive3d_tpu"}


def _port_files():
    # chip_smoke.py, the card tool and the card tests' helpers run where
    # JAX is not installed
    out = ["chip_smoke.py", "tools/torch_kernel_ab.py", "tests/mask_cases.py",
           "tests/stream_cases.py"]
    for top in ("primitive3d_tpu_torch", os.path.join("examples", "torch")):
        for dirpath, _, names in os.walk(os.path.join(ROOT, top)):
            out += [os.path.relpath(os.path.join(dirpath, n), ROOT)
                    for n in sorted(names) if n.endswith(".py")]
    return sorted(out)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            yield node.args[0].value.split(".")[0]


def test_port_has_modules():
    files = _port_files()
    assert "primitive3d_tpu_torch/raycast.py" in files
    assert "primitive3d_tpu_torch/ops/marching_tetrahedra.py" in files
    assert "examples/torch/sphere_tetrahedra.py" in files
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_import(path):
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_check_catches_a_jax_import():
    tree = ast.parse("import numpy\nfrom jax import numpy as jnp\n"
                     "import primitive3d_tpu.ops\n"
                     "importlib.import_module('jaxlib')\n")
    assert set(_imported_roots(tree)) & FORBIDDEN == FORBIDDEN
