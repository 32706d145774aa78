"""Seconds from the start of the process to the window's first timed work."""


def read(rec):
    return rec.setup_s
