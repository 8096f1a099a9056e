"""Deployment modules: a configuration whose file names one under
``"module": "<name>"`` runs ``portbench/deployments/<name>.py``'s
training, frames, call and reference in place of the harness's built-in
ones (one shape class, ``add_template`` then ``add_templates_rotate``,
gray frames of rotated instances, ``reference/line2d.py``). The harness
finds the file by name under the run's root, as it finds a metric's
reader, so a deployment is added by new files alone: its module, its
reference under ``portbench/reference/``, its configuration and its
traffic mix. A configuration without the key runs the built-in route.

A module is loaded from its path, not as a member of this package, so
it imports what it needs by absolute name (``from portbench import
frames``), and imports the program and torch inside its functions. It
provides five functions:

``train(config, seed, device)``
    The trained ``Detector``, built from the configuration's keys on
    `device`, every class trained through the port's public API only.
``fingerprint(det)``
    The trained bank of every class, in the form ``reference`` gives it
    (compared whole: a template that differs, or is on one side only,
    counts in ``bank_mismatch``).
``frame_pool(config, traffic, seed)``
    ``(pool, counts)``: the mix's ``pool`` frames, made with NumPy from
    the seed, uint8 ``[n, H, W]`` (gray) or ``[n, H, W, 3]`` (BGR), and
    the instances in each frame, from which ``frames.check_sample``
    draws the frames compared (the most instances always among them).
``client(det, traffic, pool, threshold)``
    An object with ``harness.Client``'s protocol: ``calls_per_pass``
    (one pass over the pool), ``frames_of(i)`` (call i's pool indices,
    a range), ``__call__(i)`` (those indices and one answer a frame),
    ``rows(answer)`` (an answer as int64 rows, one a match) and
    ``api_span()`` ((owner, attribute, span name) of the API entry that
    the traced run wraps).
``reference(config, traffic, seed, pool, positions, device, lower=False)``
    ``(fingerprint, {pos: set of row tuples})`` for every pool index in
    `positions`, the form ``harness.compare`` takes, worked out by plain
    arithmetic under ``portbench/reference/`` that imports nothing of
    the program and takes nothing the program made. With ``lower=True``
    it is computed one precision below the configuration's: the control
    that ``portbench.control`` runs, which has to come out not correct.

What a module cannot change stays in ``harness.py``: the warm-up pass,
the window, its clock, ``frames_per_s``, ``frame_ms_p95`` and
``setup_s``, the traced pass and its readers, ``compare``, ``verdict``
and every limit.
"""
