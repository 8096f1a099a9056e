"""Host-clock end-to-end times of the port's mode paths, one checkout.

    python tools/e2e_torch_paths.py DIR PATH [PATH ...]

Imports ``chip_smoke`` and ``shape_based_matching_tpu_torch`` from DIR (a
checkout, for instance a ``git archive`` of the parent under ``build/``),
builds each named path of ``chip_smoke.MODE_PATHS`` (``color1000``,
``masked360``, ...) as chip_smoke does, and times 60 warm
``Detector.match`` calls on the host clock (each call ends in a
download, so it synchronizes): median and quartiles in ms. Also times the
color frontend (planar BGR noise, B=1) at 1024^2 T=4 and 512^2 T=8 with
CUDA events. For a comparison run DIRs in turns in one chip call. Prints
one line: the DIR's name and a JSON object.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch


def main() -> None:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from shape_based_matching_tpu_torch import Detector
    from shape_based_matching_tpu_torch.ops.cuda.frontend import (
        quant_spread)
    try:
        from shape_based_matching_tpu_torch.ops.cuda.pyramid import pyr_down
    except ImportError:  # a checkout from before csrc/pyramid.cu
        from shape_based_matching_tpu_torch.ops.filters import (
            pyr_down_u8 as pyr_down)

    out = {}
    for name in sys.argv[2:]:
        kwargs, cid, pyr, frame, mask, thr, _ = cs._mode_path(name)
        det = Detector(**kwargs, device="cuda")
        det.class_templates[cid] = pyr
        for _ in range(5):
            det.match(frame, thr, mask=mask)
        torch.cuda.synchronize()
        ts = []
        for _ in range(60):
            t0 = time.perf_counter()
            det.match(frame, thr, mask=mask)
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = [round(float(v), 3)
                     for v in np.percentile(ts, [50, 25, 75])]
    g = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (1, 1024, 1024), dtype=np.uint8)).cuda()
    color = torch.stack([g, g.roll(1, -1), 255 - g], 1).contiguous()
    for name, x, T in (("color_frontend_1024", color, 4),
                       ("color_frontend_512", pyr_down(color), 8)):
        out[name] = round(cs._time_ms(lambda: quant_spread(x, 30.0, T), 200),
                          4)
    print(os.path.basename(root), json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
