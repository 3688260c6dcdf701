"""The share of a growth batch's iterations that belong to segments which
capacity staging threw away and ran again: 100 x the ``redone`` notes over
the ``iterations`` notes of the program's ``octa.grow.batch`` spans in the
traced window."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec)
    its = spans.noted(st, "octa.grow.batch", "iterations")
    redone = spans.noted(st, "octa.grow.batch", "redone")
    if not its or redone is None:
        return None
    return 100.0 * redone / its
