"""Published peaks of the cards the benchmark runs on, by the name that
``torch.cuda.get_device_name`` gives (NVIDIA's H100 SXM data sheet, dense
rates at the 700 W limit): float32 outside the tensor cores (the
configurations keep TF32 off) and HBM bandwidth."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str, what: str):
    """The card's peak ``what``, or None for a card not in the table."""
    return PEAKS.get(device_name, {}).get(what)
