"""Published peaks, by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA's H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (at the full
700 W power limit)."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
