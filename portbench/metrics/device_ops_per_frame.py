"""Device operations (kernels, memsets, copies) queued a frame, counted
from the host-side CUDA calls of the traced window."""


def read(w):
    if w.busy_s is None or not w.frames:
        return None
    return w.queued / w.frames
