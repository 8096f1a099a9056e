"""shape_based_matching_tpu_torch -- LINE-2D training and matching in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``shape_based_matching_tpu``, which stays the
reference it is held against bit for bit. It imports torch and never jax.

    from shape_based_matching_tpu_torch import Detector
    det = Detector(num_features=63, T=(4, 8), device="cuda")
    tid = det.add_template(train_img, "part", mask)
    det.add_templates_rotate("part", tid, range(1, 360), (cx, cy))
    matches = det.match(frame, threshold=85.0)

On CPU tensors every kernel wrapper runs its plain PyTorch twin; on CUDA
tensors it launches the kernel (built from ``csrc/`` with nvcc at first
use) or raises. Training's host helpers build from ``csrc/host.cpp`` with
the host C++ compiler at first use.
"""

from .models.detector import Detector, Match

__all__ = ["Detector", "Match"]
