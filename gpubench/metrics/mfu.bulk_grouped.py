"""The window's images times the grouped model's operations a second
(``work_grouped.model_flops``: a grouped 3x3 at its real MACs), as a share
of the card's int8 peak (1,979 TOP/s), in %."""

from gpubench import work, work_grouped


def read(r):
    if not r.window.images:
        return None
    rate = work_grouped.model_flops(r.cell.config) * r.window.images / r.window.seconds
    return 100.0 * rate / work.PEAK_INT8_OPS
