"""Device milliseconds inside NICE-GAN's G half step (the program's
``octa.train.G`` spans: four discriminator passes at their new
parameters, eight generator passes, the backward and the Adam step), the
union of the device's operation intervals within the spans of the traced
window, mean a step."""
from octa_bench import spans


def read(rec):
    st = spans.of_record(rec).get("octa.train.G")
    if not st:
        return None
    return (st["host_ms"] - st["idle_us"] * 1e-3) / st["count"]
