"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the package under test."""
import ast
import os
import subprocess
import sys

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "strique_tpu"}

REHEARSAL = r"""
import os, sys
bench = sys.argv[1]
sys.path[:0] = [os.path.dirname(bench), bench]
import run  # noqa
from harness import check, spec, trace, roofline, window  # noqa
import control  # noqa
from reference import pipeline  # noqa
for kind in ("traffic", "metrics"):
    for f in sorted(os.listdir(os.path.join(bench, kind))):
        if f.endswith(".py"):
            spec.module(kind, f[:-3])
import strique_tpu_torch.detect.detector, strique_tpu_torch.detect.writer  # noqa
import strique_tpu_torch.parallel.dispatcher, strique_tpu_torch._build  # noqa
import strique_tpu_torch.utils.logging  # noqa
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_import_graph_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", REHEARSAL, spec.HERE], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    top = set(out.stdout.split())
    assert "strique_tpu_torch" in top and "torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_is_independent():
    ref = os.path.join(spec.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".", 1)[0] for m in _imports(os.path.join(ref, f))}
            assert not tops & (FORBIDDEN | {"strique_tpu_torch", "harness"}), (f, tops)


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _d, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".", 1)[0] for m in _imports(os.path.join(dirpath, f))}
                assert not tops & FORBIDDEN, (f, tops)
