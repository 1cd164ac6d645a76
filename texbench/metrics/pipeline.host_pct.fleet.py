"""The pipeline's host stages (StageTimes: stacking, container packing) as a share of the traced span."""


def read(reading):
    return reading.host_pct()
