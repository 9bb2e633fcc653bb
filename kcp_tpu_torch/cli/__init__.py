"""kcp_tpu_torch.cli — the CLI binaries (reference: cmd/).

Each module is runnable with ``python -m kcp_tpu_torch.cli.<name>``:

- ``kcp``                  the control-plane server (cmd/kcp)
- ``cluster_controller``   standalone controllers (cmd/cluster-controller)
- ``syncer``               standalone spec/status syncer (cmd/syncer)
- ``deployment_splitter``  standalone splitter (cmd/deployment-splitter)
- ``crd_puller``           dump cluster APIs as CRD YAML (cmd/crd-puller)
- ``compat``               CRD schema compat / LCD check (cmd/compat)

Every binary that starts device work takes ``--device``: the environment
variable ``KCP_DEVICE`` when it is set, else the CUDA card, which is an
error on a host without one (no fallback to the CPU). The kernel's build
cache is ``build/kcp_tpu_torch/``; there is no compile cache to enable.
"""

import os


def add_device_argument(p) -> None:
    """The ``--device`` flag of a binary that starts device work."""
    p.add_argument("--device", default=os.environ.get("KCP_DEVICE") or None,
                   help="device of the reconcile work: cuda (the default), "
                        "cuda:N or cpu; env KCP_DEVICE. Without a card "
                        "the default is an error, not a fallback")
