"""Kernel A1's time a launch: CUDA events around each launch of the
window, summed, over the launches the port counted (``_kernels``)."""
LAYER = "kernel A1"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "ops_per_s"
KERNEL = "rle_replay"


def read(rec):
    ms = (rec.kernel_ms or {}).get(KERNEL)
    n = (rec.launches or {}).get(KERNEL, 0)
    if not ms or n <= 0:
        return None
    return sum(ms) / n
