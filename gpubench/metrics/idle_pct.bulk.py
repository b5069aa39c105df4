"""The share of the traced span in which nothing ran on the device, in %."""

from gpubench.readers import idle_pct


def read(r):
    return idle_pct(r)
