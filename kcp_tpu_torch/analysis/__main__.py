"""kcp-lint CLI for the port — contract-aware static analysis.

Usage (from the repo root):
    python -m kcp_tpu_torch.analysis                    # all checkers, text
    python -m kcp_tpu_torch.analysis --format json      # machine-readable
    python -m kcp_tpu_torch.analysis --rules cow-mutation,frozen-bytes
    python -m kcp_tpu_torch.analysis kcp_tpu_torch/store  # a subtree only

Exit status: 0 = no active findings (waived ones never fail), 1 = at
least one finding. Waive a legitimate write-boundary site by appending a
comment ``kcp-lint: disable=<rule> -- <justification>`` to the flagged
line; waivers without justification are themselves findings.
"""

import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
