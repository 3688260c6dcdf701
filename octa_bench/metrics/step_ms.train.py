"""Milliseconds of the trainer's step (``on_step``'s ``step_s``: forward,
backward, the Adam updates and the losses read back), mean a step of the
window."""


def read(rec):
    s = rec["step_s"]
    return 1e3 * sum(s) / len(s)
