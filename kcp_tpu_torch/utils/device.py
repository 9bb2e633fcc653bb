"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. There
is no silent fallback: without a card, ``None``/``"cuda"`` raises, and a
caller that wants the CPU (the tests) must ask for it by name."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None,
                   mesh=None) -> torch.device:
    """The device a caller asked for; ``None`` is the card, or the lead
    device of ``mesh`` when one is given."""
    if device is None and mesh is not None:
        return mesh.lead
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kcp_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
