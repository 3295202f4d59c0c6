"""strique_tpu_torch and chip_smoke.py never import jax or the JAX package.

The port keeps its own copies of what it needs from ``strique_tpu``
(tests/test_torch_copies.py pins them); here nothing named ``jax``,
``jax.*``, ``strique_tpu`` or ``strique_tpu.*`` may be imported, neither
when the modules load nor by an import statement inside a function.
"""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "strique_tpu")


def _port_sources():
    pkg = os.path.join(REPO, "strique_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_never_imports_jax():
    """Import every module of the port and execute every import statement
    of chip_smoke.py in a fresh interpreter; neither jax nor the JAX
    package may then be in sys.modules."""
    code = (
        "import ast, importlib, pkgutil, sys\n"
        "import strique_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'strique_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "tree = ast.parse(open('chip_smoke.py').read())\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, (ast.Import, ast.ImportFrom)):\n"
        "        exec(compile(ast.Module([node], []), 'chip_smoke.py', 'exec'), {})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'strique_tpu'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr


def test_no_import_statement_names_the_jax_package():
    """Every import statement of the port's files and chip_smoke.py, at
    module level or inside a function."""
    bad = []
    for path in _port_sources():
        with open(path) as fp:
            tree = ast.parse(fp.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where CUDA is
    unavailable (this CPU host) and where the port is not importable."""
    import shutil

    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                             timeout=120, cwd=cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
