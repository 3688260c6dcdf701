"""The device's idle share inside the growth's iterations: idle time
inside the program's ``octa.grow.iteration`` spans of the traced window
over those spans' length, in %."""
from octa_bench import spans


def read(rec):
    it = spans.of_record(rec).get("octa.grow.iteration")
    if not it or it["host_ms"] <= 0:
        return None
    return 100.0 * it["idle_us"] * 1e-3 / it["host_ms"]
