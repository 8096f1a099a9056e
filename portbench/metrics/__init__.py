"""Per-layer metric readers: one file a metric, ``<metric name>.py``, with
``read(window) -> float | None`` over a traced ``portbench.trace.Window``.
A reader that finds nothing to read returns None, and the run leaves the
metric out of its line. ``roofline.py`` is the shared table of peaks and
the counts of the work each stage must do; it is no metric."""
