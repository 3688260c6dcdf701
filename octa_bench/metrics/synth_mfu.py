"""The least time of the traced growth batch's counted work over the traced
window, in %: the networks' operations on the batch (counted from the
configuration) over the dense bfloat16 peak, plus K2's admitted-pair
operations (counted from its calls' inputs) over the float32 peak. None
where the trace holds more than the first batch."""
from octa_bench.flops import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS


def read(rec):
    dt = rec.get("device_trace")
    if dt is None or rec.get("k2_flops") is None:
        return None
    least = (rec["traced_flops"] / PEAK_BF16_FLOPS
             + rec["k2_flops"] / PEAK_FP32_FLOPS)
    return 100.0 * least / dt.window_s
