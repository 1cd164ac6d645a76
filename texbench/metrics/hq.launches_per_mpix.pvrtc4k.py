"""Device kernels launched per megapixel of HQ requests in the traced span."""


def read(reading):
    return reading.kernels_per_mpix()
