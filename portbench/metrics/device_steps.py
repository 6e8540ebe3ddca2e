"""The device steps of the staged stream (``OpTensors.num_steps``): the
serial chain each document's replay walks, as the op compiler left it."""
LAYER = "op compiler"
UNIT = "steps"
SOURCE = "program_counter"
MOVES = "ops_per_s"


def read(rec):
    return rec.counters.get("device_steps")
