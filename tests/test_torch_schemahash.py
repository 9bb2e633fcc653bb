"""The port's schema hashing against the JAX package's, on the CPU.

- The reference's own cases of ``test_schemahash.py``, run against the
  port (``port_module``; the jitted ``schema_hashes_jit`` there is the
  port's ``schema_hashes`` on a CPU tensor).
- ``schema_hashes`` is bit-equal to the reference's ``schema_hashes_jit``
  on seeded token matrices, tokens near 2**32 included, at T in {1, 7,
  256}, and whatever integer dtype carries the bit patterns.
- The tokenizer is bit-equal to the reference's in each of its three
  tiers (the ``kcptok`` extension, the native JSON-blob parser, the Python
  walk) and through the dispatcher, with and without the native library.

Every comparison is exact equality.
"""

import inspect
import random

import numpy as np
import pytest
import torch

from kcp_tpu import native as ref_native
from kcp_tpu.ops import schemahash as ref_sh
from kcp_tpu_torch import native as port_native
from kcp_tpu_torch.ops import schemahash as port_sh
from kcp_tpu_torch.ops.hashing import canonical_json

from test_torch_engine import _cases, native_libraries, port_module

MIRRORED = _cases("test_schemahash.py")


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_schemahash_case_against_the_port(ref_file, name, kwargs, request):
    fn = getattr(port_module(ref_file), name)
    args = dict(kwargs)
    for param in inspect.signature(fn).parameters:
        if param not in args:
            args[param] = request.getfixturevalue(param)
    fn(**args)


def _tokens(seed: int, b: int, t: int) -> np.ndarray:
    """Seeded uint32 tokens, a third of them within 2**16 of 2**32 and the
    extremes 0 and 2**32 - 1 in every row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 2**32, size=(b, t), dtype=np.uint64)
    near = rng.random((b, t)) < 1 / 3
    toks[near] = 2**32 - 1 - rng.integers(0, 2**16, size=int(near.sum()), dtype=np.uint64)
    toks[:, 0] = 2**32 - 1
    if t > 1:
        toks[:, -1] = 0
    return toks.astype(np.uint32)


@pytest.mark.parametrize("t", [1, 7, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_schema_hashes_bit_equal_to_the_reference(t, seed):
    toks = _tokens(seed, 97, t)
    want = np.asarray(ref_sh.schema_hashes_jit(toks))
    assert want.dtype == np.uint32
    got = port_sh.schema_hashes(torch.from_numpy(toks))
    assert got.dtype == torch.int64 and got.shape == (97,)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    # the same bit patterns in int32 (negative where the top bit is set)
    # and in int64 hash the same
    as_i32 = torch.from_numpy(toks.view(np.int32))
    np.testing.assert_array_equal(port_sh.schema_hashes(as_i32).numpy(), got.numpy())
    np.testing.assert_array_equal(
        port_sh.schema_hashes(torch.from_numpy(toks.astype(np.int64))).numpy(), got.numpy())


def test_powers_equal_the_reference():
    for t in (1, 7, 256):
        np.testing.assert_array_equal(port_sh._powers(t), ref_sh._powers(t))


def _rand_value(rng: random.Random, depth: int = 0):
    kind = rng.randrange(7 if depth < 4 else 4)
    if kind == 0:
        return rng.choice([None, True, False])
    if kind == 1:
        return rng.randint(-(2**40), 2**40)
    if kind == 2:
        return rng.choice([0.5, -1.25, 1e21, 3.0])
    if kind == 3:
        return "".join(rng.choice("ab\"\\\n中λ") for _ in range(rng.randrange(6)))
    if kind in (4, 5):
        return {f"k{rng.randrange(50)}": _rand_value(rng, depth + 1)
                for _ in range(rng.randrange(5))}
    return [_rand_value(rng, depth + 1) for _ in range(rng.randrange(4))]


def _corpus(seed: int) -> list:
    rng = random.Random(seed)
    schemas = [_rand_value(rng) for _ in range(120)]
    wide = {f"k{i:04d}": i for i in range(400)}
    deep: object = 1
    for _ in range(120):
        deep = [deep]
    return schemas + [wide, deep, {"type": "object", "properties": {
        "spec": {"type": "object", "properties": {"replicas": {"type": "integer"}}}}}]


@pytest.mark.parametrize("max_tokens", [8, 256])
def test_tokenizer_tiers_bit_equal_to_the_reference(max_tokens, monkeypatch):
    native_libraries(monkeypatch)
    schemas = _corpus(max_tokens)
    want = np.stack([ref_sh.tokenize_schema_py(s, max_tokens) for s in schemas])
    # tier 3: the Python walk
    np.testing.assert_array_equal(
        np.stack([port_sh.tokenize_schema_py(s, max_tokens) for s in schemas]), want)
    # tier 2: canonical JSON parsed and walked natively
    blobs = [canonical_json(s).encode() for s in schemas]
    got2 = port_native.tokenize_schemas_native(blobs, max_tokens)
    assert got2 is not None, "the native library did not load"
    np.testing.assert_array_equal(got2, want)
    np.testing.assert_array_equal(got2, ref_native.tokenize_schemas_native(blobs, max_tokens))
    # tier 1: the extension's direct dict walk
    tok = port_native.load_tokenizer()
    assert tok is not None, "the kcptok extension did not load"
    got1 = np.empty((len(schemas), max_tokens), np.uint32)
    assert tok.tokenize(schemas, max_tokens, got1) == 0
    np.testing.assert_array_equal(got1, want)
    # the dispatcher, on the port and on the reference
    np.testing.assert_array_equal(port_sh.tokenize_schemas(schemas, max_tokens), want)
    np.testing.assert_array_equal(ref_sh.tokenize_schemas(schemas, max_tokens), want)


def test_tokenizer_fallback_contract(monkeypatch):
    """Without the extension the JSON-shaped batch takes tier 2, a batch
    with a tuple the Python walk; without any native code, the walk. Every
    route gives the reference's tokens."""
    schemas = _corpus(3)[:40]
    odd = [{"a": (1, 2), "b": "x"}, {"c": [1, "y"]}]
    want = np.stack([ref_sh.tokenize_schema_py(s) for s in schemas])
    want_odd = np.stack([ref_sh.tokenize_schema_py(s) for s in odd])
    np.testing.assert_array_equal(port_sh.tokenize_schemas(odd), want_odd)
    monkeypatch.setattr(port_sh, "load_tokenizer", lambda: None)
    calls = []
    real = port_sh.tokenize_schemas_native

    def counted(blobs, mt):
        calls.append(len(blobs))
        return real(blobs, mt)

    monkeypatch.setattr(port_sh, "tokenize_schemas_native", counted)
    np.testing.assert_array_equal(port_sh.tokenize_schemas(schemas), want)
    np.testing.assert_array_equal(port_sh.tokenize_schemas(odd), want_odd)
    assert calls == [len(schemas)]  # the tuple batch never reached tier 2
    monkeypatch.setattr(port_sh, "tokenize_schemas_native", lambda blobs, mt: None)
    np.testing.assert_array_equal(port_sh.tokenize_schemas(schemas), want)
    assert port_sh.tokenize_schemas([]).shape == (0, 256)


def test_bucket_by_hash_equals_the_reference():
    h = np.random.default_rng(4).integers(0, 64, 3000).astype(np.uint32)
    got, want = port_sh.bucket_by_hash(h), ref_sh.bucket_by_hash(h)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_negotiation_hashes_on_its_device():
    """The controller's hash of a schema is the reference's."""
    from kcp_tpu.reconcilers.apiresource import NegotiationController as RefNeg
    from kcp_tpu.client import MultiClusterClient as RefMC
    from kcp_tpu.store import LogicalStore as RefStore
    from kcp_tpu_torch.client import MultiClusterClient
    from kcp_tpu_torch.reconcilers.apiresource import NegotiationController
    from kcp_tpu_torch.store import LogicalStore

    port = NegotiationController(MultiClusterClient(LogicalStore()), device="cpu")
    assert port.device == torch.device("cpu")
    ref = RefNeg(RefMC(RefStore()))
    for s in _corpus(9)[:20]:
        if isinstance(s, dict):
            assert port._schema_hash(s) == ref._schema_hash(s)
