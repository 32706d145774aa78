"""Chunks embedded and indexed within the window / the window's seconds."""


def read(rec):
    return rec.completed / rec.window_s if rec.info.get("ingest") else None
