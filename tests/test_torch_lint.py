"""The port's lint gate (``kcp_tpu_torch.analysis``) against the JAX
package's, on the CPU.

- The reference's own cases of ``test_lint.py``, run against the port
  (``test_torch_engine.port_module``): every checker's fixture pair, the
  waiver mechanics, and ``test_repo_lint_is_clean``, which there runs the
  port's gate with its default targets (``kcp_tpu_torch/`` and
  ``chip_smoke.py``) against ``docs/operations.md``. Every case runs.
- Parity: the port's ``run_lint`` and the reference's give the same
  report (findings with rule, path, line and message; waived findings;
  unused waivers) over the port's tree with its bench harness left out,
  where both find exactly the two ``metrics-doc-drift`` rows that the
  bench's gauntlet and trace lanes answer, and over a fixture tree with
  a finding of every rule.
- ``python -m kcp_tpu_torch.analysis`` exits 0 on the tree and 1 on the
  fixture tree, with the reference CLI's JSON report.
"""

import json
import os
import subprocess
import sys

import pytest

from kcp_tpu.analysis import runner as ref_runner
from kcp_tpu_torch.analysis import runner as port_runner
from test_torch_engine import _cases, port_module, run_mirrored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIRRORED = _cases("test_lint.py")


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirror_runs_the_ports_gate():
    """The mirrored file sees the port's checkers and runner, and every
    case of the reference file is among the mirrored ones."""
    mod = port_module("test_lint.py")
    assert mod.run_lint is port_runner.run_lint
    assert port_runner.DEFAULT_TARGETS == ("kcp_tpu_torch", "chip_smoke.py")
    assert len(MIRRORED) == 24


def test_port_lint_parity_on_the_tree_without_the_bench():
    """Over the port's files minus ``bench.py`` both gates report the
    same two findings: the gauntlet counter and the ``conv.e2e`` phase
    that ``docs/operations.md`` documents and only the bench lanes
    record. With the bench, the port's gate is clean."""
    files = tuple(p for p in port_runner.discover(REPO, port_runner.DEFAULT_TARGETS)
                  if p != os.path.join("kcp_tpu_torch", "bench.py"))
    ref = ref_runner.run_lint(REPO, targets=files).to_dict()
    port = port_runner.run_lint(REPO, targets=files).to_dict()
    assert port == ref
    got = [(f["rule"], f["path"]) for f in port["findings"]]
    assert got == [("metrics-doc-drift", "docs/operations.md")] * 2, got
    msgs = " ".join(f["message"] for f in port["findings"])
    assert "'gauntlet_runs_total'" in msgs and "'conv.e2e'" in msgs


FIXTURE = {
    "pkg/__init__.py": "",
    "pkg/faults.py": 'POINTS = frozenset({"a.b", "dead.point"})\n',
    "pkg/mod.py": '''\
import threading
import time

from .faults import maybe_fail
from .trace import REGISTRY


def cow(store):
    items, rv = store.list("configmaps")
    items[0]["x"] = 1
    items[1]["y"] = 2  # kcp-lint: disable=cow-mutation -- fixture: a private store


def frozen(store, obj):
    raw = store.encode_obj(obj)
    return bytearray(raw)


async def serve(path):
    time.sleep(0.1)
    with open(path) as f:
        return f.read()


class S:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def m1(self):
        with self._a:
            with self._b:
                pass

    def m2(self):
        with self._b:
            with self._a:
                pass


def inject():
    maybe_fail("a.b")
    maybe_fail("typo.point")
    REGISTRY.counter("undocumented_total", "help").inc()


x = 1  # kcp-lint: disable=cow-mutation
y = 2  # kcp-lint: disable=frozen-bytes -- nothing here to silence
''',
    "pkg/spans.py": '''\
from kcp_tpu_torch import obs


def f(ctx, t0, t1):
    with obs.span("server.request"):
        pass
    obs.phase("ghost", ctx, t0, t1)
''',
    "pkg/broken.py": "def f(:\n",
    "docs/operations.md": ("| `stale_metric_total` | documented, never registered |\n"
                           "<!-- trace-spans:begin -->\n"
                           "| `server.request` | the request |\n"
                           "| `conv.undocumented_emitter` | stale row |\n"
                           "<!-- trace-spans:end -->\n"),
    "tests/test_x.py": 'SPEC = "other.point:drop"\n',
}


@pytest.fixture
def fixture_tree(tmp_path):
    for rel, text in FIXTURE.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return str(tmp_path)


def test_port_lint_parity_on_a_fixture_of_every_rule(fixture_tree):
    ref = ref_runner.run_lint(fixture_tree, targets=("pkg",)).to_dict()
    port = port_runner.run_lint(fixture_tree, targets=("pkg",)).to_dict()
    assert port == ref
    assert set(port["summary"]["by_rule"]) == set(port_runner.RULES)
    assert [f["rule"] for f in port["waived"]] == ["cow-mutation"]
    assert [w["rules"] for w in port["unused_waivers"]] == ["frozen-bytes"]
    for rules in (("cow-mutation",), ("lock-order", "metrics-doc-drift")):
        ref_sub = ref_runner.run_lint(fixture_tree, rules=rules, targets=("pkg",))
        port_sub = port_runner.run_lint(fixture_tree, rules=rules, targets=("pkg",))
        assert port_sub.to_dict() == ref_sub.to_dict(), rules
        assert port_sub.render() == ref_sub.render(), rules


def test_cli_exit_codes_and_json(fixture_tree):
    clean = subprocess.run([sys.executable, "-m", "kcp_tpu_torch.analysis",
                            "--format", "json"], cwd=REPO, capture_output=True,
                           text=True, timeout=120)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    report = json.loads(clean.stdout)
    assert report["ok"] and report["summary"]["active"] == 0
    assert len(report["waived"]) <= 1 and report["unused_waivers"] == []
    dirty = subprocess.run([sys.executable, "-m", "kcp_tpu_torch.analysis",
                            "--root", fixture_tree, "--format", "json", "pkg"],
                           cwd=REPO, capture_output=True, text=True, timeout=120)
    assert dirty.returncode == 1, dirty.stdout + dirty.stderr
    ref = ref_runner.run_lint(fixture_tree, targets=("pkg",)).to_dict()
    assert json.loads(dirty.stdout) == json.loads(json.dumps(ref))
