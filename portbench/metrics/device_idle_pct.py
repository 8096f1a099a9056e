"""The device's idle share, in percent, of the untraced passes timed
just before the traced window: one less the device's busy seconds a
frame in the traced window over the untraced passes' seconds a frame.
The profiler slows the host's dispatch, so the traced window's own idle
share (``device.busy_s`` against ``device.window_s``) reads high."""


def read(w):
    if w.busy_s is None or not w.frames or not w.untraced_s_per_frame:
        return None
    return 100.0 * (1.0 - w.busy_s / w.frames / w.untraced_s_per_frame)
