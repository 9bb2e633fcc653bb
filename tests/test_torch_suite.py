"""The port's ``--suite`` lane (``python -m kcp_tpu_torch.bench --suite``)
against the reference's ``bench.py`` ``suite()``, on the CPU.

- The inputs: ``bench.py`` is loaded with importlib under a small
  ``KCP_BENCH_ROWS`` (it imports no JAX at module level), its
  ``_time_kernel`` replaced by a recorder of each timed call's function and
  arguments, its ``Deadman`` by a stub and ``os._exit`` (which ends the
  reference's lane) by an exception; ``suite_inputs`` must give byte-equal
  arrays (``uint32`` lanes compared as the bits the port carries in
  ``int32``), the 5,000 schemas' tokens included.
- The outputs, exact: ``split_replicas`` against ``split_replicas_jit``,
  ``schema_hashes`` against ``schema_hashes_jit``, the fan-out sums, and
  the A/B's decision, upsync and counts against both the reference's
  un-fused ``sync_decisions`` + ``fanout_match`` and its Pallas
  ``decide_and_match`` in interpret mode; on the lane's own inputs (which
  decide nothing and hit no selector: the downstream mirror is a copy) and
  on a seeded variant of them with dirty rows and about 30% selector hits.
- The lane: ``--suite --device cpu`` at 1,024 rows prints the reference's
  lanes and keys, its compile reported apart; without a card and without
  ``--device cpu`` it exits 2 before any run.

The rates themselves are timings: the card's (``chip_smoke.py`` phase 14),
not this host's.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kcp_tpu_torch import bench
from kcp_tpu_torch.ops import cuda_kernels
from kcp_tpu_torch.ops.labelmatch import fanout_match
from kcp_tpu_torch.ops.placement import split_replicas
from kcp_tpu_torch.ops.schemahash import schema_hashes, tokenize_schemas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2048  # the A/B's rows here (the lane's default is 131,072)

torch.set_num_threads(1)


class _Exited(Exception):
    pass


class _Deadman:
    def __init__(self, best):
        pass

    def arm(self, stage, budget_s=None):
        pass


@pytest.fixture(scope="module")
def reference():
    """The reference ``suite()`` at ``ROWS``: each timed call's function
    and its arguments as numpy arrays, and the rows it emitted."""
    calls, emitted = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KCP_BENCH_ROWS", str(ROWS))
        spec = importlib.util.spec_from_file_location("ref_bench_suite",
                                                      os.path.join(REPO, "bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        def record(fn, *args, iters=30):
            calls.append((fn, args))
            return 1.0

        def exit_(code):
            raise _Exited(code)

        mp.setattr(mod, "_time_kernel", record)
        mp.setattr(mod, "Deadman", _Deadman)
        mp.setattr(mod, "emit", emitted.append)
        mp.setattr(os, "_exit", exit_)
        with pytest.raises(_Exited):
            mod.suite()
    assert len(calls) == 5, [c[0] for c in calls]
    return {"calls": calls, "rows": emitted[-1]["suite"]}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_bits(a)))


@pytest.fixture(scope="module")
def port_inputs():
    return bench.suite_inputs(ROWS)


def test_suite_inputs_equal_the_reference(reference, port_inputs):
    calls, x = reference["calls"], port_inputs
    want = [np.asarray(a) for _fn, args in calls for a in args]
    # the un-fused and the Pallas lanes take the same seven arrays
    got = [x["replicas"], x["avail"], tokenize_schemas(x["schemas"]),
           x["fan_pair"], x["fan_sels"], *x["ab"], *x["ab"]]
    assert len(got) == len(want) == 2 + 1 + 2 + 7 + 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert x["ab"][0].shape == (ROWS, 64) and x["ab"][5].shape == (ROWS, 8)


def test_configs_2_to_4_equal_the_reference(reference, port_inputs):
    (split_fn, split_args), (hash_fn, hash_args), (fan_fn, fan_args) = reference["calls"][:3]
    x = port_inputs
    got = split_replicas(_t(x["replicas"]), _t(x["avail"]))
    assert np.array_equal(got.numpy(), np.asarray(split_fn(*split_args)))
    got = schema_hashes(_t(tokenize_schemas(x["schemas"])))
    want = np.asarray(hash_fn(*hash_args))
    assert want.dtype == np.uint32 and np.array_equal(got.numpy(), want.astype(np.int64))
    got = fanout_match(_t(x["fan_pair"]), _t(x["fan_sels"])).sum(dim=0, dtype=torch.int32)
    want = np.asarray(fan_fn(*fan_args))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.sum() > 0  # 8 pairs from 999 values against 64 selectors hit


def _seeded(ab):
    """The lane's A/B inputs with ~3% spec-dirty, ~2% status-dirty, ~2%
    deleted and ~2% not-yet-created rows and ~30% of rows carrying a
    selector among their pair hashes."""
    rng = np.random.default_rng(11)
    up, upe, down, dne, mask, pair, sels = (np.array(a) for a in ab)
    b = up.shape[0]
    down[rng.random(b) < 0.03, 0] ^= 1
    down[rng.random(b) < 0.02, -1] ^= 1
    upe[rng.random(b) < 0.02] = False
    dne[rng.random(b) < 0.02] = False
    hit = rng.random(b) < 0.3
    pair[hit, rng.integers(0, pair.shape[1], int(hit.sum()))] = rng.choice(sels, int(hit.sum()))
    return up, upe, down, dne, mask, pair, sels


@pytest.mark.parametrize("case", ["lane", "seeded"])
def test_decision_fanout_equals_the_reference(reference, case):
    (unfused, args), (pallas, pargs) = reference["calls"][3:]
    assert [np.asarray(a).tobytes() for a in args] == [np.asarray(a).tobytes() for a in pargs]
    arrays = tuple(np.asarray(a) for a in args)
    if case == "seeded":
        arrays = _seeded(arrays)
    ref_d, ref_counts = unfused(*arrays)
    want = (np.asarray(ref_d.decision), np.asarray(ref_d.status_upsync),
            np.asarray(ref_counts))
    want_p = tuple(np.asarray(o) for o in pallas(*arrays, interpret=True))
    got = cuda_kernels.decide_and_match(*(_t(a) for a in arrays))
    for g, w, wp in zip(got, want, want_p):
        g = g.numpy()
        assert np.array_equal(g, w.astype(g.dtype)) and np.array_equal(g, wp.astype(g.dtype))
    if case == "seeded":
        assert (want[0] != 0).sum() > 0 and want[1].sum() > 0 and want[2].sum() > 0.25 * ROWS


def test_suite_lane_on_the_cpu(reference):
    env = dict(os.environ, KCP_BENCH_ROWS="1024", OMP_NUM_THREADS="1",
               TORCHINDUCTOR_COMPILE_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "kcp_tpu_torch.bench", "--suite",
                           "--device", "cpu"], capture_output=True, text=True,
                          timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(r) == {"suite", "seconds", "compile_s", "device", "host_cpus", "card"}
    assert r["device"] == "cpu" and r["compile_s"] > 0
    names = [row["lane"] for row in r["suite"]]
    ref_names = [row["lane"] for row in reference["rows"]]
    assert names[:3] == ref_names[:3] == ["splitter bin-packing", "schema hash bucketing",
                                          "label fan-out"]
    assert names[3:] == ["decision+fanout eager", "decision+fanout torch.compile",
                         "decision+fanout plain (the CUDA wrapper on cpu)"]
    for row in r["suite"]:
        assert set(row) == {"lane", "scale", "rate"}
    assert [row["scale"] for row in r["suite"][:3]] == [
        row["scale"] for row in reference["rows"][:3]]
    assert {row["scale"] for row in r["suite"][3:]} == {"1024 rows x 64 slots"}
    assert "x vs torch.compile" in r["suite"][-1]["rate"]
    assert list(r["seconds"]) == names and all(v > 0 for v in r["seconds"].values())


def test_suite_without_a_card_exits_2_before_any_run():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --suite runs on it")
    env = {k: v for k, v in os.environ.items() if k != "KCP_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "kcp_tpu_torch.bench", "--suite"],
                          capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 2
    assert proc.stdout == "" and "| lane |" not in proc.stderr
    assert "CUDA card" in proc.stderr
