"""Share of the fleet's traced span with no kernel or copy on the card."""


def read(reading):
    return reading.idle_pct()
