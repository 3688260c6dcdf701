"""The window's network operations (the generator's and the segmentor's
forward passes, counted from the configuration) over the window and the
H100's dense bfloat16 peak, in %."""
from octa_bench.flops import PEAK_BF16_FLOPS


def read(rec):
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK_BF16_FLOPS
