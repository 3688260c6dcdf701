"""Host milliseconds of a growth iteration: the mean length of the
program's ``octa.grow.iteration`` spans in the traced window (redone
iterations included)."""
from octa_bench import spans


def read(rec):
    it = spans.of_record(rec).get("octa.grow.iteration")
    return it["host_ms"] / it["count"] if it else None
