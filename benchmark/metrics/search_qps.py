"""HTTP 200 answers completed in the window / the window's seconds, at the client."""


def read(rec):
    return rec.completed / rec.window_s if rec.latencies_ms else None
