"""The window's training operations (3 forwards a trained pass, 1 a pass
without gradients, counted from the configuration's passes) over the
window and the H100's dense bfloat16 peak, in %."""
from octa_bench.flops import PEAK_BF16_FLOPS


def read(rec):
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK_BF16_FLOPS
