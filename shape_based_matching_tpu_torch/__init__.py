"""shape_based_matching_tpu_torch -- LINE-2D training and matching in
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``shape_based_matching_tpu``, which stays the
reference it is held against bit for bit. It imports torch and never jax.

    from shape_based_matching_tpu_torch import Detector
    det = Detector(num_features=63, T=(4, 8), device="cuda")
    tid = det.add_template(train_img, "part", mask)
    det.add_templates_rotate("part", tid, range(1, 360), (cx, cy))
    matches = det.match(frame, threshold=85.0)
    poses = det.match_icp(frame, threshold=85.0, top_c=32)  # subpixel

On CPU tensors every kernel wrapper runs its plain PyTorch twin; on CUDA
tensors it launches the kernel (built from ``csrc/`` with nvcc at first
use) or raises. The host helpers (training's greedy passes, NMS) build
from ``csrc/host.cpp`` with the host C++ compiler at first use.

Several cards, or several shards of one: ``match_huge_frame`` (row tiles
of one large frame, ``match --spatial-shards N`` on the command line),
``match_images_sharded`` (frames x template bank over a ``make_mesh``),
``add_templates_sharded`` and ``multichip_refine_step`` (``parallel/``);
runnable demos in ``examples/``.

Model directories (``det.write_classes``, ``det.save_settings``,
``get_instance``) are the reference's OpenCV YAML; the command line is
``python -m shape_based_matching_tpu_torch --device cuda|cpu
train|match|train-db|match-db|preprocess|demo|info``.

The scalar NumPy oracle that the port is held to, on the CPU and on the
card, is ``oracle/reference.py`` (a copy of the JAX package's).
"""

__version__ = "0.1.0"

from .models.detector import Detector, Match, get_instance, reset_instance
from .models.icp import (IcpResult, MatchIcpHandle, match_icp,
                         match_icp_async, match_refine_batch,
                         refine_matches_icp)
from .models.refine import RefinedPose, refine_detections
from .models.shape_info import ShapeInfoProducer
from .models.template import Feature, Template
from .parallel.mesh import (Mesh, add_templates_sharded, make_mesh,
                            match_images_sharded, multichip_match_step,
                            multichip_refine_step, multichip_train_step,
                            shard_pad_bank)
from .parallel.spatial import (make_spatial_mesh, match_huge_frame,
                               required_halo)
from .utils.nms import nms_boxes

__all__ = [
    "__version__",
    "Detector",
    "Match",
    "Feature",
    "Template",
    "ShapeInfoProducer",
    "get_instance",
    "reset_instance",
    "nms_boxes",
    "RefinedPose",
    "refine_detections",
    "refine_matches_icp",
    "match_icp",
    "match_icp_async",
    "match_refine_batch",
    "MatchIcpHandle",
    "IcpResult",
    "Mesh",
    "make_mesh",
    "make_spatial_mesh",
    "match_images_sharded",
    "match_huge_frame",
    "required_halo",
    "add_templates_sharded",
    "multichip_match_step",
    "multichip_train_step",
    "multichip_refine_step",
    "shard_pad_bank",
]
