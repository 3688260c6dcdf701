"""The share of a growth batch's iterations replayed from a recorded tape:
100 x the ``graphed`` notes over the ``iterations`` notes of the program's
``octa.grow.batch`` spans in the traced window. A program without tapes
notes no ``graphed``: nothing to read."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec)
    its = spans.noted(st, "octa.grow.batch", "iterations")
    graphed = spans.noted(st, "octa.grow.batch", "graphed")
    if not its or graphed is None:
        return None
    return 100.0 * graphed / its
