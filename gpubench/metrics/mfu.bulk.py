"""The window's images times the model's operations a second, as a share of
the card's int8 peak (1,979 TOP/s), in %."""

from gpubench.readers import mfu_pct


def read(r):
    return mfu_pct(r)
