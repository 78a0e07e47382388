"""device.idle_share (%): the share of the traced window in which the card
ran nothing (no kernel, copy or memset), from its activity records."""


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
