"""The device's idle share over the traced window: 100 less the percent
of the window in which some operation (kernel, copy or fill) ran."""


def read(t):
    return t.idle_share_pct()
