"""The port's native build (``kcp_tpu_torch/native.py``), on the CPU.

- Six processes that load the port's library and extension at once from
  an empty build directory all load them; one file of each results, no
  temporary file is left, and nothing under ``native/`` changes (the
  reference's loader builds there; the port never does).
- A library's name is a hash of the sources' bytes, the flags and the
  interpreter's ABI: a changed byte gives a new name, a changed time does
  not.
- A failed build gives None (callers take the Python path) and leaves no
  temporary file; ``KCP_TPU_NO_NATIVE=1`` gives None without a build.

Whether the library equals the reference's behaviour is held elsewhere
(``test_torch_engine.py``, ``test_torch_schemahash.py``, the mirrored
``test_native.py`` in ``test_torch_runtime.py``).
"""

import json
import os
import shutil
import subprocess
import sys
import sysconfig

import pytest

from kcp_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys
from kcp_tpu_torch import native
native.BUILD_DIR = {build!r}
lib, tok = native.load(), native.load_tokenizer()
print(json.dumps({{"lib": lib._name if lib else None, "tok": tok.__file__ if tok else None,
                  "torch": "torch" in sys.modules}}))
"""


def _tree(path):
    return {name: os.stat(os.path.join(path, name)).st_mtime_ns for name in os.listdir(path)}


@pytest.fixture
def cxx():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native library does not build here")


def test_six_fresh_loads_share_one_build_and_leave_native_untouched(tmp_path, cxx):
    build = str(tmp_path / "build")
    before = _tree(native._NATIVE_DIR)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD.format(build=build)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    headers = os.path.exists(os.path.join(sysconfig.get_paths()["include"], "Python.h"))
    files = sorted(os.listdir(build))
    libs = [f for f in files if f.startswith("libkcpnative-") and f.endswith(".so")]
    toks = [f for f in files if f.startswith("kcptok-") and f.endswith(".so")]
    assert len(libs) == 1 and len(toks) == (1 if headers else 0), files
    assert not [f for f in files if f.endswith(".tmp")], files
    assert set(files) == {*libs, *toks, "native.lock"}, files
    for out in outs:
        assert out["lib"] == os.path.join(build, libs[0])
        assert out["tok"] == (os.path.join(build, toks[0]) if headers else None)
        assert not out["torch"], "the native loader imported torch"
    assert _tree(native._NATIVE_DIR) == before, "a load wrote under native/"


@pytest.fixture
def native_copy(tmp_path, monkeypatch):
    """A copy of ``native/``'s sources that the loader reads instead."""
    copy = tmp_path / "native"
    shutil.copytree(native._NATIVE_DIR, copy, ignore=shutil.ignore_patterns("*.o", "*.so"))
    monkeypatch.setattr(native, "_NATIVE_DIR", str(copy))
    return copy


@pytest.mark.parametrize("name", ["encode.cc", "kcptok.cc", "common.h"])
def test_a_changed_source_byte_gives_a_new_key(name, native_copy):
    src = native_copy / name
    key = native._source_key()
    os.utime(src, (0, 0))  # an older file: no rebuild by time, none needed by bytes
    assert native._source_key() == key
    data = bytearray(src.read_bytes())
    data[len(data) // 2] ^= 1
    src.write_bytes(bytes(data))
    assert native._source_key() != key
    data[len(data) // 2] ^= 1
    src.write_bytes(bytes(data))
    assert native._source_key() == key


def test_the_key_covers_the_flags_and_the_abi():
    keys = {native._source_key(), native._source_key("-I/elsewhere"),
            native._source_key("", "cpython-312-x86_64-linux-gnu"),
            native._source_key("", "cpython-313-x86_64-linux-gnu")}
    assert len(keys) == 4


def test_a_failed_build_gives_none_and_leaves_no_temporary(native_copy, tmp_path, monkeypatch,
                                                          cxx):
    (native_copy / "walstore.cc").write_text("this is not C++\n")
    build = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_info", {})
    assert native.load() is None
    assert "CalledProcessError" in native.build_info["libkcpnative"]["error"]
    assert sorted(os.listdir(build)) == ["native.lock"]


def test_no_native_env_gives_none_without_a_build(tmp_path, monkeypatch):
    monkeypatch.setenv("KCP_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "_tok_tried", False)
    assert native.load() is None and native.load_tokenizer() is None
    assert not (tmp_path / "build").exists()
