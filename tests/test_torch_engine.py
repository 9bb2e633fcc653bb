"""The port's engine stack against the JAX package's, on the CPU.

- Host encoders: ``ops/hashing`` and ``BucketEncoder`` rows bit-equal to
  the reference's, through both the native and the Python bucket paths.
- The selector compiler and its numpy twins against the reference's.
- The reference's own cases of ``test_store.py``, ``test_selectors.py``,
  ``test_watch_semantics.py``, ``test_store_index.py``, ``test_encode.py``
  and ``test_syncer_e2e.py``, run against the port: each file's source
  is loaded with ``kcp_tpu`` read as ``kcp_tpu_torch``, the fused backend
  named ``"fused"`` and the serving core put on the CPU.
- ``test_mesh_serving.drive_scenario`` through the port's
  ``start_syncer``, without a mesh and on a ``4x2`` mesh, against the
  same scenario through the JAX ``start_syncer``: equal final dumps.

Every comparison is exact equality.
"""

import asyncio
import contextlib
import functools
import inspect
import json
import os
import re
import shutil
import types

import numpy as np
import pytest
import torch

from kcp_tpu import native as ref_native
from kcp_tpu.ops import encode as ref_encode
from kcp_tpu.ops import hashing as ref_hashing
from kcp_tpu.ops import labelmatch as ref_lm
from kcp_tpu.parallel import mesh as jmesh
from kcp_tpu.store.selectors import parse_selector as ref_parse_selector
from kcp_tpu_torch import native as port_native
from kcp_tpu_torch.ops import encode as port_encode
from kcp_tpu_torch.ops import hashing as port_hashing
from kcp_tpu_torch.ops import labelmatch as port_lm
from kcp_tpu_torch.parallel import mesh as pmesh
from kcp_tpu_torch.scenarios import topology as port_topology
from kcp_tpu_torch.store.selectors import parse_selector as port_parse_selector

TESTS = os.path.dirname(os.path.abspath(__file__))

# torch's intra-op pool takes one thread per core in every process; under
# xdist's workers that oversubscribes the host several times over, and the
# port's many tiny CPU ops then slow down 15-30x (a mirrored case whose
# quarantine backoff is pinned at 120 s outlived it and diverged). Every
# worker collects this module, so each runs the port's ops on one thread.
torch.set_num_threads(1)


# ------------------------------------------------------------ mirroring


# entry points that default to the card: a mirrored file gets them bound
# to the CPU
ON_THE_CPU = ("start_syncer", "NegotiationController", "ClusterController",
              "DeploymentSplitter", "Config")


# the fleet builders a mirrored file takes from ``helpers``
FLEET_HELPERS = ("shard_fleet", "restart_shard", "move_shard")


@functools.lru_cache(maxsize=None)
def port_module(ref_file: str) -> types.ModuleType:
    """A reference test file's source, executed against the port."""
    path = os.path.join(TESTS, ref_file)
    src = open(path).read()
    src = re.sub(r"\bkcp_tpu\b", "kcp_tpu_torch", src)
    src = src.replace('backend="tpu"', 'backend="fused", device="cpu"')
    src = src.replace('"tpu"', '"fused"')
    # the port has no jit wrapper: the mirrored file calls the function
    src = src.replace("schema_hashes_jit", "schema_hashes")
    src = src.replace("FusedCore.for_current_loop()",
                      'FusedCore.for_current_loop(device="cpu")')
    # the port's binaries pick their device from KCP_DEVICE
    src = src.replace('JAX_PLATFORMS="cpu"', 'KCP_DEVICE="cpu"')
    # cores, buckets and meshes built directly in a mirrored file go on
    # the CPU too (a mesh repeats the CPU device)
    src = re.sub(r"\bFusedCore\(", 'FusedCore(device="cpu", ', src)
    src = re.sub(r"\bFusedBucket\((\w+)\)", r'FusedBucket(\1, device="cpu")', src)
    src = re.sub(r"\bmake_mesh\(n_devices=(\d+)",
                 r'make_mesh(devices=["cpu"] * \1, n_devices=\1', src)
    mod = types.ModuleType(f"port_{ref_file[:-3]}")
    mod.__file__ = path
    exec(compile(src, f"{path} (against kcp_tpu_torch)", "exec"), mod.__dict__)
    for name in ON_THE_CPU:
        if name in mod.__dict__:
            setattr(mod, name, functools.partial(getattr(mod, name), device="cpu"))
    # ``from helpers import shard_fleet`` binds the reference's fleet
    # (helpers re-exports kcp_tpu.scenarios.topology): the port's is bound
    # in its place. helpers' own wait_until stays.
    for name in FLEET_HELPERS:
        if getattr(mod.__dict__.get(name), "__module__", "").startswith("kcp_tpu."):
            setattr(mod, name, getattr(port_topology, name))
    # ``from test_sharding import _cm`` imports the reference test file: the
    # names come from its mirror instead
    for other, names in re.findall(r"^from (test_\w+) import \(?([\w\s,]+)\)?",
                                   src, re.M):
        ported = port_module(f"{other}.py")
        for name in re.findall(r"\w+", names):
            setattr(mod, name, getattr(ported, name))
    if "schema_hashes" in mod.__dict__:
        hashes = mod.schema_hashes
        mod.schema_hashes = lambda toks: hashes(torch.from_numpy(np.asarray(toks)))
    return mod


def _grid(fn) -> list[dict]:
    """The keyword sets of a test function's parametrize marks."""
    grid = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")] \
            if isinstance(mark.args[0], str) else list(mark.args[0])
        rows = [v if len(names) > 1 else (v,) for v in mark.args[1]]
        grid = [dict(g, **dict(zip(names, row))) for g in grid for row in rows]
    return grid


def _cases(ref_file: str, skip=()):
    """(file, test name, kwargs) for every test function of the file and
    every test method of its ``Test*`` classes (named ``Class.method``),
    expanding their parametrize marks; the file's own ``pytestmark``
    (e.g. a skip without the native library) rides along."""
    mod = port_module(ref_file)
    marks = getattr(mod, "pytestmark", [])
    marks = marks if isinstance(marks, list) else [marks]
    tests = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and callable(obj):
            tests.append((name, obj))
        elif name.startswith("Test") and isinstance(obj, type):
            tests += [(f"{name}.{m}", fn) for m, fn in vars(obj).items()
                      if m.startswith("test_") and callable(fn)]
    out = []
    for name, fn in tests:
        if name in skip:
            continue
        for i, kw in enumerate(_grid(fn)):
            out.append(pytest.param(ref_file, name, kw, marks=marks,
                                    id=f"{ref_file[5:-3]}::{name}[{i}]"))
    return out


MIRRORED = (
    _cases("test_store.py")
    + _cases("test_selectors.py")
    + _cases("test_watch_semantics.py")
    + _cases("test_store_index.py")
    + _cases("test_encode.py")
    + _cases("test_syncer_e2e.py")
)


def _mirrored_callable(mod: types.ModuleType, name: str):
    if "." in name:
        cls, meth = name.split(".")
        return getattr(getattr(mod, cls)(), meth)
    return getattr(mod, name)


def _call_with_fixtures(fn, kwargs: dict, request):
    args = dict(kwargs)
    for param in inspect.signature(fn).parameters:
        if param not in args:
            args[param] = request.getfixturevalue(param)
    return fn(**args)


def run_mirrored(ref_file: str, name: str, kwargs: dict, request) -> None:
    """Call a mirrored case, its other arguments taken from pytest's
    fixtures (a fixture the reference file defines must be importable
    from the calling test module). The file's autouse fixtures that the
    calling module does not provide wrap the call, as they wrap it in
    the reference."""
    mod = port_module(ref_file)
    with contextlib.ExitStack() as stack:
        for fname, fix in vars(mod).items():
            marker = getattr(fix, "_fixture_function_marker", None)
            if marker is None or not marker.autouse or fname in request.fixturenames:
                continue
            got = _call_with_fixtures(fix._get_wrapped_function(), {}, request)
            if inspect.isgenerator(got):
                stack.enter_context(contextlib.contextmanager(lambda g=got: g)())
        _call_with_fixtures(_mirrored_callable(mod, name), kwargs, request)


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_modules_run_against_the_port():
    """The loader really swaps the package: the mirrored files see the
    port's classes, never the reference's."""
    from kcp_tpu_torch.store import LogicalStore
    from kcp_tpu_torch.syncer import syncer as port_syncer

    assert port_module("test_store.py").LogicalStore is LogicalStore
    start = port_module("test_syncer_e2e.py").start_syncer
    assert start.func is port_syncer.start_syncer and start.keywords == {"device": "cpu"}
    assert len(MIRRORED) > 40


# --------------------------------------------------------------- hashing


def _values(rng, n):
    scalars = [True, False, 1, 0, -1, 2**31, 2**40, 1.5, -0.0, "", "x", "1", "True",
               None, "ünï", 3.14159, 10**20]
    out = list(scalars)
    for _ in range(n):
        k = int(rng.integers(0, 4))
        if k == 0:
            out.append(str(rng.integers(0, 10**6)))
        elif k == 1:
            out.append({f"k{j}": int(rng.integers(-5, 5)) for j in range(int(rng.integers(0, 4)))})
        elif k == 2:
            out.append([bool(rng.integers(0, 2)), None, "v"][: int(rng.integers(0, 4))])
        else:
            out.append(float(rng.normal()))
    return out


def test_hashes_bit_equal_reference():
    rng = np.random.default_rng(3)
    vals = _values(rng, 200)
    for v in vals:
        assert port_hashing.hash_value(v) == ref_hashing.hash_value(v), v
    # True and 1 hash apart (the cache keys on the type), 0 is "absent"
    assert port_hashing.hash_value(True) != port_hashing.hash_value(1)
    assert 0 not in {port_hashing.hash_value(v) for v in vals}
    for k in ("app", "kcp.dev/cluster", "", "ü"):
        assert port_hashing.hash_key(k) == ref_hashing.hash_key(k)
        for v in ("east", "", "1", "x" * 300):
            assert port_hashing.hash_pair(k, v) == ref_hashing.hash_pair(k, v)
    for data in (b"", b"abc", bytes(range(256))):
        assert port_hashing.fnv1a(data) == ref_hashing.fnv1a(data)


# --------------------------------------------------------------- encoder


def _objects(rng, n):
    objs = []
    for i in range(n):
        data = {f"f{j}": (str(rng.integers(0, 50)) if j % 3 else int(rng.integers(0, 5)))
                for j in range(int(rng.integers(0, 12)))}
        obj = {"apiVersion": "v1", "kind": "ConfigMap",
               "metadata": {"name": f"o{i}", "namespace": f"ns{i % 3}",
                            "resourceVersion": str(i), "uid": f"u{i}",
                            "labels": {"kcp.dev/cluster": f"c{i % 4}", "tier": str(i % 2)}},
               "data": data}
        if rng.random() < 0.5:
            obj["status"] = {"ready": bool(rng.integers(0, 2)), "n": int(rng.integers(0, 9)),
                             "conditions": [{"type": "A", "status": "True"}]}
        if rng.random() < 0.2:
            obj["spec"] = {"nested": {"deep": {"er": [1, 2, {"x": True}]}}}
        objs.append(obj)
    return objs


def _encoder(mod, capacity, native: bool):
    enc = mod.BucketEncoder(capacity=capacity)
    if not native:
        enc._native_tried = True  # the Python bucket path
    return enc


def _encode_or_overflow(enc, obj):
    """The encoded row, or None when the bucket overflowed."""
    try:
        return enc.encode(obj).copy()
    except (port_encode.BucketOverflow, ref_encode.BucketOverflow):
        return None


def native_libraries(monkeypatch):
    """The port's native library and the reference's, both loaded; a skip
    only where no C++ compiler is present.

    The reference's loader is tried again here, after the port's build:
    at collection every worker's reference loader runs ``make`` in
    ``native/`` at once, and one that loses that race keeps None for the
    worker's life. The retry is undone after the test."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: neither native library builds here")
    port = port_native.load()
    assert port is not None, f"the port's native library did not load: {port_native.build_info}"
    monkeypatch.setattr(ref_native, "_load_attempted", False)
    monkeypatch.setattr(ref_native, "_lib", None)
    ref = ref_native.load()
    assert ref is not None, "the reference's native library did not load"
    return port, ref


def test_native_library_matches_reference_availability(monkeypatch):
    port, ref = native_libraries(monkeypatch)
    assert os.path.dirname(port._name) == port_native.BUILD_DIR != os.path.dirname(ref._name)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_bucket_encoder_rows_bit_equal_reference(native, monkeypatch):
    """Rows, slot vocabulary and status mask equal the reference's,
    through the same bucket path; overflow and growth included."""
    if native:
        native_libraries(monkeypatch)
    rng = np.random.default_rng(17)
    objs = _objects(rng, 80)
    port, ref = _encoder(port_encode, 16, native), _encoder(ref_encode, 16, native)
    for obj in objs:
        got, want = _encode_or_overflow(port, obj), _encode_or_overflow(ref, obj)
        if got is None or want is None:
            assert got is None and want is None, "only one side overflowed"
            port, ref = port.grown(), ref.grown()
            if not native:
                port._native_tried = ref._native_tried = True
            got, want = port.encode(obj).copy(), ref.encode(obj).copy()
        np.testing.assert_array_equal(got, want)
        assert port.slot_paths == ref.slot_paths
    assert port.capacity > 16, "overflow/growth went vacuous"
    assert (port._native is not None) == native
    np.testing.assert_array_equal(port.status_mask(), ref.status_mask())
    batch_p = port.encode_batch(objs[:10] + [None])
    batch_r = ref.encode_batch(objs[:10] + [None])
    np.testing.assert_array_equal(batch_p.values, batch_r.values)
    np.testing.assert_array_equal(batch_p.exists, batch_r.exists)


def test_native_and_python_bucket_paths_agree(monkeypatch):
    native_libraries(monkeypatch)
    objs = _objects(np.random.default_rng(5), 40)
    fast, slow = _encoder(port_encode, 128, True), _encoder(port_encode, 128, False)
    for obj in objs:
        np.testing.assert_array_equal(fast.encode(obj), slow.encode(obj))
    assert fast.slot_paths == slow.slot_paths and fast._native is not None


def test_label_encoders_and_flatten_bit_equal_reference():
    objs = _objects(np.random.default_rng(9), 30)
    for obj in objs:
        assert port_encode.flatten_object(obj) == ref_encode.flatten_object(obj)
        labels = obj["metadata"]["labels"]
        for got, want in zip(port_encode.encode_labels(labels, 4),
                             ref_encode.encode_labels(labels, 4)):
            np.testing.assert_array_equal(got, want)
    label_list = [o["metadata"]["labels"] for o in objs] + [None, {}]
    for got, want in zip(port_encode.encode_label_batch(label_list, 4),
                         ref_encode.encode_label_batch(label_list, 4)):
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- selectors

SELECTORS = [
    "a=b", "a!=b", "a in (x,y,z)", "a notin (x)", "a", "!a",
    "a=b,c!=d", "kcp.dev/cluster=east,tier in (0,1),!gone",
    "a in (1,2,3,4,5,6,7,8,9)",  # too many alternatives for the kernel
    "a,b,c,d,e,f,g,h,i",  # too many requirements
    "",
]


@pytest.mark.parametrize("spec", SELECTORS)
def test_selector_compiler_and_numpy_twins_match_reference(spec):
    port_sel, ref_sel = port_parse_selector(spec), ref_parse_selector(spec)
    got = port_lm.try_compile_selector(port_sel)
    want = ref_lm.try_compile_selector(ref_sel)
    assert (got is None) == (want is None)
    rng = np.random.default_rng(len(spec))
    keys = ["a", "b", "c", "kcp.dev/cluster", "tier", "gone"]
    vals = ["b", "x", "y", "1", "0", "east", "d"]
    label_list = [{k: str(rng.choice(vals)) for k in rng.choice(keys, int(rng.integers(0, 4)),
                                                                 replace=False)}
                  for _ in range(64)]
    np.testing.assert_array_equal(port_lm.match_host(port_sel, label_list),
                                  ref_lm.match_host(ref_sel, label_list))
    if got is None:
        return
    for field in ("alts", "negate", "use_key", "valid"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    pair, key = ref_encode.encode_label_batch(label_list, 4)
    np.testing.assert_array_equal(port_lm.match_batch_np(pair, key, got),
                                  ref_lm.match_batch_np(pair, key, want))
    # the twin agrees with the host oracle and with the port's torch lane
    np.testing.assert_array_equal(port_lm.match_batch_np(pair, key, got),
                                  port_lm.match_host(port_sel, label_list))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                   if a.dtype == np.uint32 else a)
    dev = port_lm.match_batch(t(pair), t(key), t(got.alts), t(got.negate),
                              t(got.use_key), t(got.valid))
    np.testing.assert_array_equal(dev.numpy(), port_lm.match_batch_np(pair, key, got))
    sel_hashes = np.unique(pair[pair != 0])[:8]
    np.testing.assert_array_equal(port_lm.fanout_match_np(pair, sel_hashes),
                                  ref_lm.fanout_match_np(pair, sel_hashes))


# ----------------------------------------------------------- serving path


def _jax_drive(mesh):
    from test_mesh_serving import drive_scenario

    down, up, _bucket, _state = asyncio.run(drive_scenario(mesh))
    return down, up


@pytest.mark.parametrize("spec", [None, "4x2"], ids=["single", "mesh_4x2"])
def test_drive_scenario_matches_jax_start_syncer(spec):
    """test_mesh_serving.drive_scenario through the port's start_syncer,
    with and without a mesh, ends with the JAX run's store contents."""
    drive = port_module("test_mesh_serving.py").drive_scenario
    mesh = None if spec is None else pmesh.mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
    down, up, bucket, state = asyncio.run(drive(mesh))
    ref_down, ref_up = _jax_drive(None if spec is None else jmesh.mesh_from_spec(spec))
    assert json.dumps(down, sort_keys=True) == json.dumps(ref_down, sort_keys=True)
    assert json.dumps(up, sort_keys=True) == json.dumps(ref_up, sort_keys=True)
    assert len(down) == 19 and up["cm-5"] == {"ready": True}
    assert bucket.mesh is mesh and bucket.stats["ticks"] >= 2
    assert isinstance(state.up_vals, pmesh.ShardedTensor) == (mesh is not None)
    if mesh is not None:
        assert len(state.up_vals.blocks) == 4 and len(state.up_vals.blocks[0]) == 2


def test_serving_mesh_process_default_reaches_the_engines():
    """set_serving_mesh installs a default that start_syncer's core picks
    up with no per-call plumbing (test_mesh_serving's case)."""
    from kcp_tpu_torch.client import Client
    from kcp_tpu_torch.store import LogicalStore
    from kcp_tpu_torch.syncer import start_syncer

    mod = port_module("test_mesh_serving.py")
    pmesh.set_serving_mesh(pmesh.mesh_from_spec("8", devices=[torch.device("cpu")] * 8))
    try:
        async def main():
            up, down = Client(LogicalStore(), "t"), Client(LogicalStore(), "p")
            syncer = await start_syncer(up, down, ["configmaps"], "c1")
            eng = syncer.engines[0]
            assert eng.core.mesh is pmesh.get_serving_mesh()
            up.create("configmaps", mod.cm("a", {"k": "v"}))
            await mod.eventually(lambda: down.get("configmaps", "a", "default"))
            assert eng._section.bucket.mesh is pmesh.get_serving_mesh()
            await syncer.stop()

        asyncio.run(main())
    finally:
        pmesh.set_serving_mesh(None)


def test_engine_backend_names():
    from kcp_tpu_torch.client import Client
    from kcp_tpu_torch.store import LogicalStore
    from kcp_tpu_torch.syncer import BatchSyncEngine

    up, down = Client(LogicalStore(), "t"), Client(LogicalStore(), "p")
    assert BatchSyncEngine(up, down, "configmaps", "c1").fused
    assert not BatchSyncEngine(up, down, "configmaps", "c1", backend="host").fused
    with pytest.raises(ValueError, match="fused"):
        BatchSyncEngine(up, down, "configmaps", "c1", backend="tpu")


def test_openapi_from_crds_waits_for_the_schema_lane():
    """Without an attached document, ``openapi_v2`` synthesizes one from
    the cluster's CRDs, equal to the reference's for the same CRDs (and
    None for a cluster without any)."""
    from kcp_tpu.apis import crd as ref_crd
    from kcp_tpu.client import Client as RefClient
    from kcp_tpu.store import LogicalStore as RefStore
    from kcp_tpu_torch.apis import crd as port_crd
    from kcp_tpu_torch.client import Client
    from kcp_tpu_torch.store import LogicalStore

    store = LogicalStore()
    store.openapi_doc = {"swagger": "2.0"}
    assert Client(store, "t").openapi_v2() == {"swagger": "2.0"}
    store.openapi_doc = None
    assert Client(store, "t").openapi_v2() is None

    schema = {"type": "object", "properties": {"spec": {
        "type": "object", "properties": {"replicas": {"type": "integer"},
                                         "image": {"type": "string"}}}}}
    docs = []
    for crdapi, client in ((ref_crd, RefClient(RefStore(), "t")),
                           (port_crd, Client(LogicalStore(), "t"))):
        for group, plural, kind in (("apps", "deployments", "Deployment"),
                                    ("example.dev", "widgets", "Widget")):
            client.create(crdapi.CRDS, crdapi.new_crd(group, "v1", plural, kind,
                                                      schema=schema))
        docs.append(client.openapi_v2())
    assert docs[1] is not None and docs[1]["definitions"]
    assert docs[1] == docs[0]