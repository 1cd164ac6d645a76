"""The port's kernels' least time (bytes over HBM) over their device time in the fleet's traced span."""


def read(reading):
    return reading.roofline_pct()
