"""Milliseconds the device stood idle inside the adapted path's stages a
request: idle time inside the program's ``octa.adapt.*`` spans of the
traced window (splat, noise, generator, segment, threshold) over its
``octa.adapt.generator`` spans, one a request."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec)
    gen = st.get("octa.adapt.generator")
    if not gen:
        return None
    idle = sum(v["idle_us"] for k, v in st.items()
               if k.startswith("octa.adapt."))
    return idle * 1e-3 / gen["count"]
