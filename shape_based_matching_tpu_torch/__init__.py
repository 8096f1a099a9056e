"""shape_based_matching_tpu_torch -- the LINE-2D match path in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``shape_based_matching_tpu``, which stays the
reference it is held against bit for bit. It imports torch and never jax.

    from shape_based_matching_tpu_torch import Detector
    det = Detector(num_features=63, T=(4, 8), device="cuda")
    det.class_templates["bench"] = pyramids   # e.g. utils.synthetic bank
    matches = det.match(frame, threshold=85.0)

On CPU tensors every kernel wrapper runs its plain PyTorch twin; on CUDA
tensors it launches the kernel (built from ``csrc/`` with nvcc at first
use) or raises.
"""

from .models.detector import Detector, Match

__all__ = ["Detector", "Match"]
