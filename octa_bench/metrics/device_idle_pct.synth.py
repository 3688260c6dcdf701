"""100 x (1 - the union of the device's operation intervals / the traced
window), from the profiler's trace of the run."""


def read(rec):
    dt = rec.get("device_trace")
    return None if dt is None else dt.idle_pct()
