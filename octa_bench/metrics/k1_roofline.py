"""K1's share of its roofline in the traced window: the least time of its
calls (per call the larger of its operations over the float32 peak and its
bytes over the HBM rate, counted from the call's inputs) over the device
time of its binning and splat kernels, in %. None where the trace holds
fewer splat launches than calls were made (the profiler dropped events)."""


def read(rec):
    dt = rec.get("device_trace")
    if dt is None or not rec.get("k1_calls"):
        return None
    t_splat, n_splat = dt.kernel("splat_kernel(")
    t_bin, _ = dt.kernel("bin_kernel(", "float2")
    if n_splat < rec["k1_calls"] or t_splat <= 0:
        return None
    return 100.0 * rec["k1_bound_s"] / (t_splat + t_bin)
