"""Train a rotation template bank and persist it (angle_test pattern).

The reference's canonical training flow (test.cpp:262-420): extract ONE
template from an ROI, derive every other rotation by direct feature
rotation (no image re-rendering), write the class YAML and the shape-info
registry. The batched rotation makes a 1-degree sweep one vectorised
pass.

Usage: python -m shape_based_matching_tpu_torch.examples.train_rotation_bank
       [out_dir] [--device cuda|cpu]
"""

import argparse
import os
import tempfile

import numpy as np

from shape_based_matching_tpu_torch import Detector, ShapeInfoProducer
from shape_based_matching_tpu_torch.utils.synthetic import (
    synthetic_shape_image)


def main(out_dir: str | None = None, angle_step: float = 1.0,
         size: int = 256, device: str = "cuda") -> str:
    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "sbm_bank")
    os.makedirs(out_dir, exist_ok=True)
    img = synthetic_shape_image(size, seed=0)
    mask = np.full(img.shape, 255, np.uint8)

    det = Detector(num_features=63, T=(4, 8), device=device)
    shapes = ShapeInfoProducer(img, mask)
    shapes.angle_range = [0.0, 360.0]
    shapes.angle_step = angle_step
    shapes.produce_infos()

    # the first angle trains from pixels; the rest derive by the batched
    # feature rotation (equal to add_template_rotate angle by angle)
    first = shapes.infos[0]
    first_id = det.add_template(shapes.src_of(first), "part",
                                shapes.mask_of(first))
    kept = [first] if first_id != -1 else []
    rest = shapes.infos[1:]
    if first_id != -1 and rest:
        ids = det.add_templates_rotate(
            "part", first_id, [i.angle - first.angle for i in rest],
            (size / 2.0, size / 2.0))
        kept.extend(info for info, tid in zip(rest, ids) if tid != -1)

    det.write_classes(os.path.join(out_dir, "%s.yaml.gz"))
    det.save_settings(os.path.join(out_dir, "detector_linemod.yaml"),
                      templates_dir=out_dir)
    ShapeInfoProducer.save_infos(kept, os.path.join(out_dir, "infos.yaml"))
    print(f"{det.num_templates('part')} templates -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out_dir, device=args.device)
