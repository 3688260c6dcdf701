"""Device operations a growth iteration: every device operation of the
traced window (``DeviceTrace.ops`` counts; the window's adapt and segment
requests are counted in) over the ``iterations`` notes of the program's
``octa.grow.batch`` spans there."""
from octa_bench import spans


def read(rec):
    its = spans.noted(spans.of_record(rec), "octa.grow.batch", "iterations")
    if not its:
        return None
    return sum(n for _, n in rec["device_trace"].ops.values()) / its
