"""The harness's built-in route stated as a deployment module: one star
class trained by ``add_template`` then ``add_templates_rotate``, gray
frames of rotated instances from ``frames``, the built-in client, and
the reference bank and match sets from ``reference/training.py`` and
``reference/line2d.py``. ``test_bench_modules.py`` copies it into a
benchmark root as ``portbench/deployments/star_rotation.py``."""

import numpy as np

from portbench import frames, harness


def train(config, seed, device):
    from shape_based_matching_tpu_torch import Detector

    shape = frames.shape_image(config, seed)
    det = Detector(num_features=int(config["num_features"]),
                   T=tuple(int(t) for t in config["T"]),
                   weak_threshold=float(config["weak_threshold"]),
                   strong_threshold=float(config["strong_threshold"]),
                   device=device)
    tid = det.add_template(shape, harness.CLASS_ID, np.full_like(shape, 255))
    det.add_templates_rotate(harness.CLASS_ID, tid,
                             frames.template_angles(config)[1:],
                             (shape.shape[1] / 2.0, shape.shape[0] / 2.0))
    return det


def fingerprint(det):
    return harness.port_fingerprint(det)


def frame_pool(config, traffic, seed):
    shape = frames.shape_image(config, seed)
    return (frames.frame_pool(config, traffic, shape, seed),
            frames.instance_counts(traffic, seed))


def client(det, traffic, pool, threshold):
    return harness.Client(det, traffic, pool, threshold)


def reference(config, traffic, seed, pool, positions, device, lower=False):
    import torch

    from portbench.control import to_bfloat16
    from portbench.reference import line2d, training

    shape = frames.shape_image(config, seed)
    T = tuple(int(t) for t in config["T"])

    def bank(**narrow):
        return training.train_bank(
            shape, frames.template_angles(config),
            int(config["num_features"]), len(T),
            float(config["weak_threshold"]),
            float(config["strong_threshold"]), **narrow)

    trained = bank()
    banks = [line2d.pack_bank(training.level_views(trained, l), device)
             for l in range(len(T))]
    score = torch.bfloat16 if lower else torch.float32
    sets = {}
    for pos in positions:
        f = torch.from_numpy(np.ascontiguousarray(pool[pos])).to(device)
        sets[pos] = line2d.match_frame(
            f, banks, T, float(config["weak_threshold"]),
            float(config["match_threshold"]), score)
    fp = training.fingerprint(bank(narrow=to_bfloat16) if lower else trained)
    return fp, sets
