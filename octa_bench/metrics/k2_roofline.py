"""K2's share of its roofline in the traced window: the least time of its
calls (per call the larger of 8 operations a (query, point) pair its masks
admit over the float32 peak and its bytes over the HBM rate, counted from
the call's inputs) over the device time of its kernel, in %. None where the
trace holds fewer launches than calls were made."""


def read(rec):
    dt = rec.get("device_trace")
    if dt is None or not rec.get("k2_calls"):
        return None
    t, n = dt.kernel("nearest_kernel")
    if n < rec["k2_calls"] or t <= 0:
        return None
    return 100.0 * rec["k2_bound_s"] / t
