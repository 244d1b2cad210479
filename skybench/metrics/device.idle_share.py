"""1 - (union of the device's busy intervals) / (the traced window's wall)."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * rec.trace.idle_share
