"""The port's kernels' least time (the larger of bytes over HBM and operations over the float32 peak, texbench/roofline.py) over their device time in the HQ path's traced span."""


def read(reading):
    return reading.roofline_pct()
