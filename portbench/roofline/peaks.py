"""The card's published peaks (NVIDIA's H100 SXM data sheet, at the full
700 W power limit) and the least time a piece of work can take.

``PEAK_FP64`` is the sheet's "FP64 Tensor Core" rate, the card's highest
for this type.  The port's kernels issue no FP64 MMA: their vector FP64
rate is 34 TFLOP/s.  The roof is the higher rate all the same, so that no
implementation, with tensor cores or without, can read over 100%."""

PEAK_BYTES = 3.35e12   # HBM3 bytes/s
PEAK_FP64 = 67e12      # FP64 operations/s (tensor cores)


def least_seconds(nbytes, flops):
    """The larger of the bytes over the HBM rate and the FP64 operations
    over the peak rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP64)
