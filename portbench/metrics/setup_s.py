"""Set-up: the process's start to the window's start (history, kernel
build or cache hit, the port's compile and staging, one warm-up
replay)."""
UNIT = "s"
SOURCE = "host_clock"


def read(rec):
    return rec.setup_s
