"""1 - the union of device operations' intervals / the profiled sub-window."""


def read(rec):
    s = rec.summary
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"]) if s and s["window_us"] > 0 else None
