"""Share of a pair cell's traced stretch in which no operation ran on the
card, in %: 1 - (union of the device operations' intervals) / (the
stretch)."""


def read(view):
    if view.window_us <= 0 or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
