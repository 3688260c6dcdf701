"""Host milliseconds of ``RemoveSmallObjects`` (scipy, after the copy to
the host) a training step: the program's ``octa.post.remove_small_objects``
spans over its ``octa.train.step`` spans in the traced window."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec)
    step, rso = st.get("octa.train.step"), st.get("octa.post.remove_small_objects")
    return rso["host_ms"] / step["count"] if step and rso else None
