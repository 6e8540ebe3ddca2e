"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated`` after a reset at the start)."""
UNIT = "GiB"
SOURCE = "host_clock"


def read(rec):
    return rec.mem_peak_bytes / 2 ** 30 if rec.mem_peak_bytes else None
