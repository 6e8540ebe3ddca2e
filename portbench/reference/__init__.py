"""The plain reference: what every document of a replay must hold, worked
out again from the history's patches alone. It imports nothing of the
port and nothing of JAX."""
