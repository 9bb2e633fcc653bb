"""Nothing the benchmark loads is JAX or the JAX package. Names are
compared whole, before the first dot: the port's name begins with the JAX
package's."""

import ast
import json
import os
import subprocess
import sys

from portbench.__main__ import FORBIDDEN, forbidden_modules

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    seen = set()
    for base, _dirs, files in os.walk(PKG):
        for name in (f for f in files if f.endswith(".py")):
            with open(os.path.join(base, name), encoding="utf-8") as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    seen.update(a.name.split(".")[0] for a in node.names)
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    seen.add(node.module.split(".")[0])
    assert "kcp_tpu_torch" in seen
    assert not seen & set(FORBIDDEN)


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kcp_tpu_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxon", sys)
    assert "kcp_tpu_torch_lookalike" not in forbidden_modules()
    assert "jaxon" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "kcp_tpu.fake", sys)
    assert forbidden_modules() == ["kcp_tpu.fake"]


def test_a_run_loads_neither(bench_copy):
    cell = bench_copy.add_cell("tiny")
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {os.path.dirname(PKG)!r})\n"
        "from portbench import spec\n"
        "from portbench.__main__ import forbidden_modules\n"
        "from portbench.cell import run_cell\n"
        f"cell = spec.load_cell({cell!r}, root={bench_copy.root!r})\n"
        "result, _ = run_cell(cell, 5, 1.0, True, time.perf_counter(), device='cpu')\n"
        "print(json.dumps({'correct': result['correct'], 'loaded': forbidden_modules(),\n"
        "                  'port': 'kcp_tpu_torch' in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "loaded": [], "port": True}
