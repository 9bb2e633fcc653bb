"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name()`` gives: NVIDIA's H100 SXM data sheet, at the
full power limit of 700 W (the run prints the card's own limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
