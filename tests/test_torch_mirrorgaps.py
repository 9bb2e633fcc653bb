"""Reference test runs that the port's mirrors did not cover yet.

- The reference CI's sanitize lane (``scripts/ci.sh``) runs the
  store-index and encode-cache fuzzes under ``KCP_SANITIZE=1``: every
  stored snapshot frozen, every encode-cache hit re-verified, lock orders
  tracked. Here the port's mirrors of ``test_store_index.py`` and
  ``test_encode_cache.py`` run the same way, in a fresh pytest process
  whose every case sees the port's sanitizer on.
- The two host-only cases of ``test_labelmatch.py`` that need no JAX
  function: ``try_compile_selector``'s ``labelmatch_fallback_total``
  count and ``compile_selector`` with custom ``pair_hash`` /
  ``key_hash``, the reference file's source loaded with ``kcp_tpu`` read
  as ``kcp_tpu_torch``.
"""

import json
import os
import re
import subprocess
import sys
import types

import pytest

from test_torch_engine import _cases

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# records, for every case the child pytest runs, whether the port's
# sanitizer is on as the case starts
_PROBE = r"""
import json, sys
import pytest

seen = []


class Probe:
    def pytest_runtest_call(self, item):
        from kcp_tpu_torch.analysis import sanitize

        seen.append(sanitize.enabled())


rc = pytest.main(sys.argv[1:], plugins=[Probe()])
print("PROBE " + json.dumps({"rc": int(rc), "cases": len(seen), "on": sum(seen)}))
"""


def test_store_index_and_encode_cache_mirrors_pass_under_the_sanitizer():
    want = len(_cases("test_store_index.py")) + len(_cases("test_encode_cache.py"))
    env = dict(os.environ, KCP_SANITIZE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, "tests/test_torch_engine.py",
         "tests/test_torch_runtime.py", "-q", "-p", "no:xdist", "-p", "no:randomly",
         "-p", "no:cacheprovider", "-k", "store_index or encode_cache"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("PROBE ")]
    assert lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(lines[-1][6:])
    assert got == {"rc": 0, "cases": want, "on": want}, proc.stdout[-3000:]


def _labelmatch_mirror() -> types.ModuleType:
    """``test_labelmatch.py`` against the port; its jitted names read as
    the port's tensor functions (the two cases here call neither)."""
    path = os.path.join(TESTS, "test_labelmatch.py")
    src = re.sub(r"\bkcp_tpu\b", "kcp_tpu_torch", open(path).read())
    src = re.sub(r"\b(fanout_match|match_batch)_jit\b", r"\1", src)
    mod = types.ModuleType("port_test_labelmatch")
    mod.__file__ = path
    exec(compile(src, f"{path} (against kcp_tpu_torch)", "exec"), mod.__dict__)
    return mod


@pytest.mark.parametrize("name", ["test_try_compile_oversized_returns_none_and_counts",
                                  "test_compile_selector_custom_hashers"])
def test_labelmatch_host_case_against_the_port(name):
    from kcp_tpu_torch.ops import labelmatch
    from kcp_tpu_torch.utils.trace import REGISTRY

    mod = _labelmatch_mirror()
    assert mod.compile_selector is labelmatch.compile_selector
    assert mod.REGISTRY is REGISTRY
    getattr(mod, name)()
