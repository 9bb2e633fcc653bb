"""The port's CLI binaries, TLS, pull-mode pod emulation and recovery
against the JAX package's, on the CPU.

- The reference's own cases of ``test_cli.py``, ``test_tls.py``,
  ``test_pullmode.py`` and ``test_recovery.py``, run against the port
  (``port_module``: ``kcp_tpu`` read as ``kcp_tpu_torch``, the
  subprocesses' ``JAX_PLATFORMS="cpu"`` read as ``KCP_DEVICE="cpu"``).
  No case is left out.
- No fallback hides the card: ``python -m kcp_tpu_torch.cli.kcp start``
  with controllers and without ``--device`` exits non-zero on a host
  without one, names the card in its error and never says ``serving
  at``; with ``--no-install-controllers`` it serves; ``KCP_DEVICE=cpu``
  serves with controllers.
- The flags that differ from the reference's: no ``--pallas``, and
  ``--backend`` takes ``fused`` (the reference's ``tpu``) or ``host``.
"""

import os
import signal
import subprocess
import sys

import pytest
import torch

from test_torch_engine import _cases, port_module, run_mirrored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIRRORED = (_cases("test_cli.py") + _cases("test_tls.py") + _cases("test_pullmode.py")
            + _cases("test_recovery.py"))


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_cli_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_cli_files_run_against_the_port():
    from kcp_tpu_torch.cli import kcp

    assert port_module("test_recovery.py").kcp_cli is kcp
    assert port_module("test_cli.py").build_parser is kcp.build_parser
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    assert len(names) == 6 + 7 + 6 + 7


def _kcp(*args, env_extra=None, timeout=60):
    """``kcp start`` as a subprocess: (exit code or None while serving,
    first stdout line, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "KCP_DEVICE"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "kcp_tpu_torch.cli.kcp", "start", "--in-memory",
         "--no-tls", "--listen-port", "0", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if "serving at" in line:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=timeout)
        assert rc == 0
        return None, line, proc.stderr.read()
    rc = proc.wait(timeout=timeout)
    return rc, line + proc.stdout.read(), proc.stderr.read()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_kcp_start_with_controllers_and_no_card_exits_without_serving():
    rc, out, err = _kcp()
    assert rc not in (None, 0)
    assert "serving at" not in out
    assert "runs on a CUDA card by default" in err


def test_kcp_start_serves_without_controllers_and_on_the_cpu():
    rc, out, _err = _kcp("--no-install-controllers")
    assert rc is None and "serving at http://" in out
    rc, out, _err = _kcp(env_extra={"KCP_DEVICE": "cpu"})
    assert rc is None and "serving at http://" in out


def test_flags_that_differ_from_the_reference():
    from kcp_tpu_torch.cli import cluster_controller, deployment_splitter, kcp
    from kcp_tpu_torch.cli import syncer as syncer_cli

    with pytest.raises(SystemExit):
        kcp.build_parser().parse_args(["start", "--pallas"])
    args = kcp.build_parser().parse_args(["start", "--device", "cpu", "--mesh", "4"])
    cfg = kcp.config_from_args(args)
    assert cfg.device == "cpu" and cfg.mesh == "4" and not hasattr(cfg, "pallas")
    base = ["--to-server", "http://x", "--cluster", "c", "configmaps"]
    with pytest.raises(SystemExit):
        syncer_cli.build_parser().parse_args(["--backend", "tpu", *base])
    assert syncer_cli.build_parser().parse_args(base).backend == "fused"
    for mod in (cluster_controller, deployment_splitter):
        ns = mod.build_parser().parse_args([])
        assert ns.backend == "fused" and ns.device is None


def test_device_flag_defaults_to_kcp_device(monkeypatch):
    from kcp_tpu_torch.cli import kcp

    monkeypatch.setenv("KCP_DEVICE", "cpu")
    assert kcp.build_parser().parse_args(["start"]).device == "cpu"
    monkeypatch.delenv("KCP_DEVICE")
    assert kcp.build_parser().parse_args(["start"]).device is None
