"""The reference's opt-in serving soak (``tests/test_soak.py``) against the
port: sustained random churn through ``start_syncer``'s fused backend,
the tracking structures bounded while it runs and every object converged
at quiesce.

The reference file's source is loaded with ``kcp_tpu`` read as
``kcp_tpu_torch`` and its syncer put on ``KCP_SOAK_DEVICE`` (``cpu`` by
default). It stays opt-in as in the reference (``KCP_SOAK=1``, about
two minutes; ``KCP_SOAK_SECONDS`` shortens it). The file imports neither
JAX nor the JAX package, so on the card machine it runs alone:

    KCP_SOAK=1 KCP_SOAK_DEVICE=cuda python -m pytest --noconftest \\
        -p no:cacheprovider tests/test_torch_soak.py
"""

import os
import re
import types

TESTS = os.path.dirname(os.path.abspath(__file__))
DEVICE = os.environ.get("KCP_SOAK_DEVICE", "cpu")


def _mirror() -> types.ModuleType:
    path = os.path.join(TESTS, "test_soak.py")
    src = re.sub(r"\bkcp_tpu\b", "kcp_tpu_torch", open(path).read())
    src = src.replace('backend="tpu"', f'backend="fused", device={DEVICE!r}')
    mod = types.ModuleType("port_test_soak")
    mod.__file__ = path
    exec(compile(src, f"{path} (against kcp_tpu_torch)", "exec"), mod.__dict__)
    return mod


_SOAK = _mirror()
# the reference file's opt-in skip, on its soak case only
test_soak_sustained_churn_converges_and_stays_bounded = _SOAK.pytestmark(
    _SOAK.test_soak_sustained_churn_converges_and_stays_bounded)


def test_soak_mirror_runs_the_port():
    """The loader really swaps the package (this case runs without the
    opt-in too: it only inspects the mirror)."""
    from kcp_tpu_torch.syncer import start_syncer

    assert _SOAK.start_syncer is start_syncer
    assert "kcp_tpu." not in repr(_SOAK.LogicalStore)
