"""Nothing the benchmark runs imports JAX or the JAX package, or reads the
JAX package's benchmarks: top-level module names compared whole."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from h100bench.harness import guard

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_guard_compares_top_level_names_whole():
    mods = {"repro_torch": 1, "repro_torch.api": 1, "reproduce": 1,
            "repro": 1, "repro.core": 1, "jax.numpy": 1, "jaxlib": 1,
            "flax.linen": 1, "jaxtyping": 1}
    assert guard.forbidden_loaded(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def test_no_source_names_a_forbidden_module():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", "") == "import_module" \
                    and node.args and isinstance(node.args[0], ast.Constant):
                names = [node.args[0].value]
            for n in names:
                top = n.split(".")[0]
                assert top not in guard.FORBIDDEN + ("benchmarks",), \
                    f"{path.name} imports {n}"


def test_what_a_run_loads_is_clean():
    """A fresh interpreter loads the harness, every generator, reader and
    the program modules they drive, and then holds no module of JAX or the
    JAX package (compared transitively, by whole top-level names)."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from h100bench.harness import bench, main, reference, trace, churn, data
from h100bench.traffic import jobs, open_loop
import h100bench.control, h100bench.sweep
import repro_torch.api, repro_torch.runtime, repro_torch.serve
import repro_torch.core.elastic, repro_torch.kernels.usec_segmented
b = bench.benchmark()
for m in b["end_to_end"] + b["per_layer"]:
    bench.reader(m["name"])
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "h100bench" in tops
    assert not tops & set(guard.FORBIDDEN)
