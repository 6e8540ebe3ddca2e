"""The 95th percentile over every replay of the window of one replay's
host time, from its call to the synchronize that ends it."""
from portbench.stats import percentile

UNIT = "ms"
SOURCE = "host_clock"


def read(rec):
    return percentile(rec.samples, 95) * 1e3
