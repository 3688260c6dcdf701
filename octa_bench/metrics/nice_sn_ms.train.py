"""Host milliseconds inside the spectral norms' power iterations (the
program's ``octa.nice.spectral_norm`` spans, 72 a step: what launching
their matrix-vector products costs the host), a step (over the
``octa.train.D`` spans of the traced window)."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec)
    sn, d = st.get("octa.nice.spectral_norm"), st.get("octa.train.D")
    if not sn or not d:
        return None
    return sn["host_ms"] / d["count"]
