"""Frames scored by the coarse step, a frame: each ``coarse_extract``
call counts the frames of its batch, so 1.0 is no overflow re-run."""


def read(w):
    calls = w.records.get("coarse_extract", [])
    if not calls or not w.frames:
        return None
    return sum(c["frames"] for c in calls) / w.frames
