"""Requests answered in the window / launches of the masked score +
segment-max kernel over it (the program's launch counter)."""


def read(rec):
    launches = rec.counters.get("score_segmax_launches", 0)
    return rec.window_work / launches if launches else None
