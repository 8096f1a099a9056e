"""Runnable examples of the port's API, each a module with a ``main``:

    python -m shape_based_matching_tpu_torch.examples.train_rotation_bank
    python -m shape_based_matching_tpu_torch.examples.streaming_match
    python -m shape_based_matching_tpu_torch.examples.deployment_loop
    python -m shape_based_matching_tpu_torch.examples.multichip_match

Each takes ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain twins)."""
