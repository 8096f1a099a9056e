"""Multi-device matching: frames x template bank sharded over a mesh.

Runs the whole match on every shard: each builds the pyramid of its
frames, scores its slice of the template bank and refines its own
candidates; the lists are gathered on the first device. Asserts that
the lists equal the single-device ``Detector.match``.

With ``--device cuda`` the mesh spans the visible cards, round-robin when
``n_devices`` exceeds them (one card runs every shard in turn); with
``--device cpu`` the n shards run on the CPU.

Usage: python -m shape_based_matching_tpu_torch.examples.multichip_match
       [n_devices] [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch


def main(n_devices: int = 8, device: str = "cuda") -> None:
    from shape_based_matching_tpu_torch.parallel.mesh import (
        make_mesh, match_images_sharded)
    from shape_based_matching_tpu_torch.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=64,
                                            num_features=48, size=128,
                                            device=device)
    frames = np.stack([
        synthetic_scene(256, 256, templ_img, n_instances=2, seed=s)
        for s in range(2)
    ])

    mesh = make_mesh(n_devices, devices=None if device == "cuda"
                     else [torch.device(device)])
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    sharded = match_images_sharded(det, frames, threshold=85.0, mesh=mesh)
    single = [det.match(f, 85.0) for f in frames]

    for i, (a, b) in enumerate(zip(sharded, single)):
        assert [(m.template_id, m.x, m.y, m.similarity) for m in a] == \
               [(m.template_id, m.x, m.y, m.similarity) for m in b]
        print(f"frame {i}: {len(a)} matches — sharded == single-device")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n_devices, device=args.device)
