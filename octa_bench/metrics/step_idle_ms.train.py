"""Milliseconds the device stood idle inside a training step: idle time
inside the program's ``octa.train.step`` spans of the traced window, mean
a step."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec).get("octa.train.step")
    return st["idle_us"] * 1e-3 / st["count"] if st else None
