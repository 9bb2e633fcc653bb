"""The port's admission chain against the reference's, on one seeded
stream of writes.

The port's ``AdmissionChain.admit_nowait`` must decide as the reference's
chain decides: the same stream of creates, updates and deletes (tenants
with and without a hard limit, nameless and malformed bodies,
ResourceQuota writes, a flow budget that runs dry, injected
``admission.*`` faults for a stretch) goes through a port chain and a
reference chain built alike, each on its own store and a shared fake
clock, and every write's outcome (its ticket's kind or its error's HTTP
status), every flow's tokens and the ledger's usage, reservations and
limits are equal after each step.
"""

import numpy as np
import pytest

from kcp_tpu import faults as ref_faults
from kcp_tpu.admission import FlowController as RefFlow
from kcp_tpu.admission import build_chain as ref_build_chain
from kcp_tpu.store.store import LogicalStore as RefStore
from kcp_tpu.utils.errors import ApiError as RefApiError
from kcp_tpu_torch import faults as port_faults
from kcp_tpu_torch.admission import FlowController as PortFlow
from kcp_tpu_torch.admission import build_chain as port_build_chain
from kcp_tpu_torch.store.store import LogicalStore as PortStore
from kcp_tpu_torch.utils.errors import ApiError as PortApiError

FAULTS = "admission.chain:error=0.2;admission.flow:error=0.1;admission.quota:error=0.2"


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _side(flow_cls, build, store_cls, clock):
    store = store_cls()
    chain = build(store, flow=flow_cls(concurrency=4, rate=20.0, burst=8.0, queues=4,
                                       queue_depth=2, seed=3, clock=clock))
    return store, chain


def _write(rng, i):
    """One seeded write: (verb, resource, cluster, object or None)."""
    cluster = f"t{int(rng.integers(4))}"
    kind = int(rng.integers(10))
    if kind == 0:
        obj = {"apiVersion": "v1", "kind": "ResourceQuota",
               "metadata": {"name": "q", "namespace": "default"},
               "spec": {"hard": {"count/configmaps": int(rng.integers(2, 6))}}}
        return "create", "resourcequotas", cluster, obj
    if kind == 1:
        return "create", "configmaps", cluster, {"metadata": {"namespace": "default"}}
    if kind == 2:
        return "create", "configmaps", cluster, {"metadata": ["not", "a", "map"]}
    if kind == 3:
        return "update", "configmaps", cluster, {"metadata": {"name": f"cm{i}"}}
    if kind == 4:
        return "delete", "configmaps", cluster, None
    meta = ({"generateName": "cm-"} if kind == 5 else {"name": f"cm{i}"})
    return "create", "configmaps", cluster, {"metadata": dict(meta, namespace="default")}


def _outcome(chain, api_error, args):
    try:
        got = chain.admit_nowait(*args)
    except api_error as err:
        return ("error", err.code)
    if not hasattr(got, "ok"):
        got.close()  # a queued admission: never awaited here
        return ("queued",)
    kind = type(got).__name__
    got.ok()
    return ("ticket", kind)


def _state(chain):
    flow, ledger = chain.flow, chain.ledger
    keys = sorted(ledger._idx)
    return (flow._in_flight, flow._qdepth, sorted(flow._fids.items()),
            [round(t, 9) for t in flow._tokens],
            [(k, int(ledger._usage[ledger._idx[k]]), ledger._reserved[ledger._idx[k]],
              int(ledger._hard[ledger._idx[k]])) for k in keys])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_chain_decides_as_the_reference_chain(seed):
    clock = Clock()
    ref_store, ref_chain = _side(RefFlow, ref_build_chain, RefStore, clock)
    port_store, port_chain = _side(PortFlow, port_build_chain, PortStore, clock)
    rng = np.random.default_rng(seed)
    try:
        for i in range(400):
            if i in (150, 200):  # a stretch of injected admission faults
                for mod in (ref_faults, port_faults):
                    mod.install(mod.FaultInjector(FAULTS, seed=seed) if i == 150 else None)
            clock.t += float(rng.exponential(0.04))
            verb, resource, cluster, obj = _write(rng, i)
            if resource == "resourcequotas" and verb == "create":
                # the limit the quota sets, as the recount path applies it
                for ledger in (ref_chain.ledger, port_chain.ledger):
                    ledger.set_hard(cluster, "configmaps",
                                    obj["spec"]["hard"]["count/configmaps"])
            args = (verb, resource, cluster, "default", obj)
            n_obs = port_chain._seconds.n
            want = _outcome(ref_chain, RefApiError, args)
            got = _outcome(port_chain, PortApiError, args)
            assert got == want, (i, args)
            assert port_chain._seconds.n == n_obs + 1, i
            assert _state(port_chain) == _state(ref_chain), (i, args)
    finally:
        ref_faults.clear()
        port_faults.clear()
        ref_store.close()
        port_store.close()
