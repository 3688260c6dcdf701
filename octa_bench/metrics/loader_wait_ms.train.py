"""Milliseconds the engine's loop waited for a batch (``on_step``'s
``wait_s``), mean a step of the window."""


def read(rec):
    w = rec["wait_s"]
    return 1e3 * sum(w) / len(w)
