"""``device_idle.*`` (%): the share of the profiled window in which no
operation ran on the card (1 - union of device intervals / window)."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)
