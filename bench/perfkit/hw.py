"""The benchmark's own table of peaks (NVIDIA's H100 SXM data sheet, dense
rates at the 700 W limit), kept apart from the program's so that no change
to the program moves the yardstick."""

PEAK_BF16_FLOPS = 989e12      # dense bf16 on the tensor cores, FLOP/s
PEAK_HBM_BYTES_S = 3.35e12    # HBM3, bytes/s

# The link the Plan is priced on: NVLink4 between the cards of one host.
NVLINK_BYTES_S = 450e9        # per direction, per card
NVLINK_ALPHA_S = 2e-6         # seconds per exchange step
