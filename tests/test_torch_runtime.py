"""The port's runtime pieces against the reference's own tests, on the CPU.

The reference's cases of ``test_runtime.py`` (work queue, controllers,
informers), ``test_fairqueue.py`` (the native fair queue and its
fallback), ``test_raceguard.py``, ``test_sanitize.py`` (the port's
``analysis/sanitize.py``), ``test_native.py`` (hash, tokenizer and
encoder parity with the native library, the WAL engine) and
``test_encode_cache.py`` (the handler's encode-once serving), run
against the port: each file's source is loaded with ``kcp_tpu`` read as
``kcp_tpu_torch`` (``test_torch_engine.port_module``). Nothing is left
out.
"""

import pytest

from test_torch_engine import _cases, run_mirrored

FILES = ("test_runtime.py", "test_fairqueue.py", "test_raceguard.py",
         "test_sanitize.py", "test_native.py", "test_encode_cache.py")
MIRRORED = [c for f in FILES for c in _cases(f)]


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_runtime_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_runtime_files_cover_their_classes():
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    assert ("test_native.py", "TestHashParity.test_fnv1a") in names
    assert ("test_fairqueue.py", "TestFairness.test_round_robin_interleaves") in names
    # 10 + 13 + 5 + 11 + 24 + 14 test functions and methods
    assert len(names) == 77
