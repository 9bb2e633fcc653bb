"""kcp-lint for the port: contract-aware static analysis + the runtime
sanitizer (the port's copy of ``kcp_tpu.analysis``).

Static side (``python -m kcp_tpu_torch.analysis`` / :mod:`.runner`): one
AST checker per cross-layer contract — CoW snapshot mutation, frozen
encode-once bytes, async/blocking discipline, lock-order acyclicity, the
KCP_FAULTS point registry, and metrics/docs drift against
``docs/operations.md`` — with per-line
``kcp-lint: disable=<rule> -- <justification>`` comment waivers. It
lints ``kcp_tpu_torch/`` and ``chip_smoke.py`` by default.

Runtime side (:mod:`.sanitize`, ``KCP_SANITIZE=1``): the two data
contracts crash loudly instead of corrupting silently — store snapshots
freeze, cached bytes verify on every hit, and a lock tracker asserts the
same acquisition-order acyclicity the static pass checks.
"""

from .base import Finding  # noqa: F401
from .runner import RULES, LintReport, run_lint  # noqa: F401
