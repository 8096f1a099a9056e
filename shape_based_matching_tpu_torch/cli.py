"""Command-line driver -- the test_jabil.cpp equivalent, DB-free or on the
tag database -- on the PyTorch port.

The JAX package's CLI (same subcommands, flags, defaults, files written
and printed lines) with one top-level ``--device`` (default ``cuda``;
``cpu`` runs every kernel's plain PyTorch twin). Without a card
``--device cuda`` raises, as ``Detector`` does. Frames and model
directories in PNG (or PGM/PPM) need no image library and no PyYAML.

    # train templates from an image (+optional mask) over an angle/scale grid
    python -m shape_based_matching_tpu_torch --device cuda train \\
        --model-dir models --class-id tag --image fiducial.png \\
        --angles 0,90,180,270 --scales 0.9:1.1:0.1 --num-features 63

    # batch-match a directory of images
    python -m shape_based_matching_tpu_torch --device cuda match \\
        --model-dir models --test-dir frames/ --threshold 90 \\
        --nms 0.5 --verify-ccorr 0.8 --csv timings.csv --annotate out/
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from .utils.imageio import load_image as _load_image

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _parse_range(spec: str):
    """'0.9:1.1:0.1' -> (lo, hi, step); '1.0' -> single value."""
    parts = [float(p) for p in spec.split(":")]
    if len(parts) == 1:
        return parts[0], parts[0], 1.0
    if len(parts) == 2:
        return parts[0], parts[1], 1.0
    return parts[0], parts[1], parts[2]


def crop_to_stride(img: np.ndarray, stride: int) -> np.ndarray:
    """Crop to stride-multiple dims (test.cpp:215-218 / test_jabil.cpp:349)."""
    h, w = img.shape[:2]
    return img[: (h // stride) * stride, : (w // stride) * stride]


def _images(test_dir: str) -> list[str]:
    return sorted(p for p in glob.glob(os.path.join(test_dir, "*"))
                  if p.lower().endswith(_IMAGE_EXTS))


def _boxes(det, matches):
    """(x, y, w, h) boxes and scores of matches, for nms_boxes."""
    boxes, scores = [], []
    for m in matches:
        t0 = det.get_templates(m.class_id, m.template_id)[0]
        boxes.append((m.x, m.y, t0.width, t0.height))
        scores.append(m.similarity)
    return boxes, scores


def add_sweep(det, srcs: list, class_id: str, masks: list, sscales: list,
              orientations: list, tag_field_ids=None,
              fiducial_src: str = "none") -> list[int]:
    """Train the renders of a sweep in order, one ``add_templates`` batch
    per run of equal-shaped renders (a scale, or a 90-degree turn of a
    crop that is not square, changes the shape); returns their template
    ids. The JAX package stacks the whole sweep into one batch and fails
    on a sweep over several scales."""
    tids: list[int] = []
    i = 0
    while i < len(srcs):
        j = i + 1
        while j < len(srcs) and srcs[j].shape == srcs[i].shape:
            j += 1
        tids += det.add_templates(
            np.stack(srcs[i:j]), class_id, np.stack(masks[i:j]),
            sscales=sscales[i:j], orientations=orientations[i:j],
            tag_field_ids=(None if tag_field_ids is None
                           else tag_field_ids[i:j]),
            fiducial_src=fiducial_src)
        i = j
    return tids


def cmd_train(args) -> int:
    from .models.detector import Detector
    from .models.shape_info import ShapeInfoProducer
    from .utils import viz

    det = Detector(num_features=args.num_features,
                   T=tuple(int(t) for t in args.T.split(",")),
                   weak_threshold=args.weak, strong_threshold=args.strong,
                   device=args.device)

    img = _load_image(args.image, gray=args.gray)
    mask = (_load_image(args.mask, gray=True) if args.mask
            else np.full(img.shape[:2], 255, np.uint8))

    producer = ShapeInfoProducer(img, mask)
    angles = [float(a) for a in args.angles.split(",")] if args.angles else [0.0]
    lo, hi, step = _parse_range(args.scales)
    scales = []
    s = lo
    while s <= hi + 1e-5:
        scales.append(round(s, 6))
        s += step

    fid_path = os.path.join(args.model_dir, f"{args.class_id}.fid.png")
    # render the whole sweep on the host, then train it in batches
    # (equal to per-variant add_template calls)
    sweep = [(angle, scale) for scale in scales for angle in angles]
    tids = add_sweep(
        det, [producer.transform(img, a, s) for a, s in sweep],
        args.class_id,
        [(producer.transform(mask, a, s) > 0) * np.uint8(255)
         for a, s in sweep],
        sscales=[s for _, s in sweep], orientations=[a for a, _ in sweep],
        fiducial_src=fid_path)
    infos = []
    for (angle, scale), tid in zip(sweep, tids):
        print(f"angle={angle} scale={scale} -> template_id={tid}")
        if tid != -1:
            infos.append((angle, scale))

    os.makedirs(args.model_dir, exist_ok=True)
    det.write_classes(os.path.join(args.model_dir, "%s.yaml.gz"))
    det.save_settings(os.path.join(args.model_dir, "detector_linemod.yaml"),
                      templates_dir=os.path.abspath(args.model_dir))
    # save the fiducial source crop next to the model like the reference
    # does (test_jabil.cpp:70-76 writes modelFileNameFid before training);
    # match-time verification re-renders from THIS stored image.
    viz.save_image(img, fid_path)
    registry_path = os.path.join(args.model_dir, "registry.json")
    registry = {}
    if os.path.exists(registry_path):
        with open(registry_path) as f:
            registry = json.load(f)
    registry[args.class_id] = {
        "source_image": os.path.abspath(args.image),
        "fiducial_image": fid_path,
        "infos": [{"angle": a, "scale": s} for a, s in infos],
    }
    with open(registry_path, "w") as f:
        json.dump(registry, f, indent=2)
    print(f"saved {det.num_templates(args.class_id)} templates for "
          f"'{args.class_id}' to {args.model_dir}")
    return 0


def load_registry_detector(model_dir: str, device="cuda"):
    """A detector on `device` with the model directory's settings and
    every class of its registry (or every ``*.yaml.gz`` without one)."""
    from .models.detector import Detector

    det = Detector.load_settings(
        os.path.join(model_dir, "detector_linemod.yaml"), device=device)
    registry_path = os.path.join(model_dir, "registry.json")
    if os.path.exists(registry_path):
        with open(registry_path) as f:
            class_ids = list(json.load(f).keys())
    else:
        class_ids = [
            os.path.basename(p)[: -len(".yaml.gz")]
            for p in glob.glob(os.path.join(model_dir, "*.yaml.gz"))
        ]
    det.read_classes(class_ids, os.path.join(model_dir, "%s.yaml.gz"))
    return det


def _stages(rec) -> list[float]:
    """Host milliseconds of an inspection's stages in a recording of it:
    the match (the ``sbm.inspect`` span less the two others), the NMS
    (``sbm.inspect.nms``) and the gate (``sbm.inspect.gate``)."""
    ms = dict.fromkeys(("sbm.inspect", "sbm.inspect.nms",
                        "sbm.inspect.gate"), 0.0)
    for sp in rec.spans:
        if sp is not None and sp.name in ms:
            ms[sp.name] += (sp.end_ns - sp.start_ns) / 1e6
    total, nms_ms, gate_ms = ms.values()
    return [total - nms_ms - gate_ms, nms_ms, gate_ms]


def _register_fiducials(det, fiducial_path) -> None:
    """``det.set_fiducial`` for every template whose stored fiducial crop
    ``fiducial_path(class_id, templ)`` names (read once a file, gray)."""
    images = {}
    for class_id in det.class_ids():
        by_path = {}
        for tid, tp in enumerate(det.class_templates[class_id]):
            path = fiducial_path(class_id, tp[0])
            if path is not None:
                by_path.setdefault(path, []).append(tid)
        for path, tids in by_path.items():
            if path not in images:
                images[path] = _load_image(path, gray=True)
            det.set_fiducial(class_id, images[path], tids)


def cmd_match(args) -> int:
    from .models.inspect import inspect_matches
    from .utils import viz
    from .utils.profiling import recording, span
    from .utils.timer import CSVStat
    from .utils.verify import bgr2gray_u8

    det = load_registry_detector(args.model_dir, args.device)
    stride = det.T_at_level[-1] * (2 ** (det.pyramid_levels - 1))

    # Register the stored fiducial source images ONCE (the reference
    # holds them in matchedFiducials across the batch, test_jabil.cpp:126)
    registry = {}
    registry_path = os.path.join(args.model_dir, "registry.json")
    if os.path.exists(registry_path):
        with open(registry_path) as f:
            registry = json.load(f)

    def fiducial_path(class_id: str, templ):
        """The stored fiducial crop of a template, or None."""
        path = getattr(templ, "fiducial_src", "") or ""
        if path in ("", "none") or not os.path.exists(path):
            entry = registry.get(class_id, {})
            path = entry.get("fiducial_image") or entry.get("source_image")
            if not path or not os.path.exists(path):
                return None
        return path

    if args.verify_ccorr > 0:
        _register_fiducials(det, fiducial_path)

    paths = _images(args.test_dir)
    if not paths:
        print(f"no images in {args.test_dir}", file=sys.stderr)
        return 1

    spatial_mesh = None
    if args.spatial_shards:
        from .parallel.spatial import make_spatial_mesh

        # --device cuda: every visible card, round-robin past them
        spatial_mesh = make_spatial_mesh(
            args.spatial_shards,
            None if args.device == "cuda" else [args.device])

    stats = CSVStat(["MATCH", "NMS", "VERIFY"])
    for path in paths:
        img = crop_to_stride(_load_image(path, gray=args.gray), stride)
        # the reference's gate (test_jabil.cpp:185-211) runs in
        # Detector.inspect: stored fiducial crop ->
        # rotateScaleImage(sscale, orientation) -> template-rect crop ->
        # minmax-normalize -> CCORR >= thresh, for every NMS-kept match
        with recording() as rec:
            if spatial_mesh is not None:
                # row-sharded huge-frame match (exact; parallel/spatial.py);
                # the frame height must divide by the shard count. Tiles
                # that overflow the cap re-run at a cap that holds them
                # all, so the lines are those of the single-device match
                from .parallel.spatial import match_huge_frame

                with span("sbm.inspect"):
                    matches = match_huge_frame(det, img, args.threshold,
                                               mesh=spatial_mesh,
                                               cand_cap=None)
                    results = inspect_matches(det, img[None], [matches],
                                              args.nms, args.verify_ccorr)[0]
                n_matches = len(matches)
            else:
                n0 = det.counters["matches"]
                results = det.inspect(img, args.threshold, nms=args.nms,
                                      ccorr=args.verify_ccorr)
                n_matches = det.counters["matches"] - n0
        stage = _stages(rec)
        kept = [r.match for r in results if r.passed]

        icp_by_match = {}
        if args.icp and kept:
            from .models.icp import refine_matches_icp

            gray_img = img if img.ndim == 2 else bgr2gray_u8(img)
            for r_icp in refine_matches_icp(det, gray_img, kept):
                icp_by_match[id(r_icp["match"])] = r_icp

        stats.append(stage)
        print(f"{os.path.basename(path)}: {n_matches} matches, "
              f"{len(kept)} after NMS/verify "
              f"[match {stage[0]:.1f} ms]")
        for m in kept[: args.top_k]:
            line = (f"  class={m.class_id} tid={m.template_id} "
                    f"x={m.x} y={m.y} sim={m.similarity:.2f}")
            ri = icp_by_match.get(id(m))
            if ri is not None and ri["valid"]:
                line += (f" icp[x={ri['tx']:.2f} y={ri['ty']:.2f} "
                         f"dtheta={ri['dtheta_deg']:+.3f} "
                         f"dscale={ri['dscale']:.4f} "
                         f"rmse={ri['rmse']:.2f}]")
            print(line)

        if args.annotate:
            os.makedirs(args.annotate, exist_ok=True)
            out = viz.draw_matches(img, kept, det)
            viz.save_image(out, os.path.join(
                args.annotate, os.path.basename(path) + ".match.png"))
        if args.debug:
            _debug_dumps(det, img, os.path.join(args.annotate or ".",
                                                os.path.basename(path)))

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(stats.summary_csv() + "\n")
        print(f"timing summary -> {args.csv}")
    return 0


def _debug_dumps(det, img: np.ndarray, out_base: str) -> None:
    """jabil_test1-style kernel dumps (test_old.cpp:14-113): magnitude,
    quantized orientations, and all response maps at level 0."""
    from .ops.response import response_maps, spread, to_i32
    from .utils import viz

    grads = det._quantized(img)
    mag_img = np.sqrt(grads.magnitude.cpu().numpy())
    mag_img = (mag_img / max(mag_img.max(), 1e-6) * 255).astype(np.uint8)
    viz.save_image(mag_img, out_base + ".magnitude.png")
    viz.save_image(viz.display_quantized(to_i32(grads.angle).cpu().numpy()),
                   out_base + ".quant.png")
    sp = spread(grads.angle, det.T_at_level[0])
    resp = response_maps(sp, det.num_orientations).cpu().numpy()
    for o in range(resp.shape[0]):
        viz.save_image((resp[o] * 63).astype(np.uint8),
                       out_base + f".resp{o}.png")


def cmd_train_db(args) -> int:
    """DB-driven template creation (test_jabil.cpp:47-118
    createLinemod2DTemplates): pull every tag model's fiducial crops from
    the plant database, save each crop next to the model image, and train
    an (angle x scale) template sweep per crop."""
    from .db import TagDB, extract_tag_model_fiducials, fiducial_crop_path
    from .models.detector import Detector
    from .models.shape_info import ShapeInfoProducer
    from .utils import viz

    det = Detector(num_features=args.num_features,
                   T=tuple(int(t) for t in args.T.split(",")),
                   weak_threshold=args.weak, strong_threshold=args.strong,
                   device=args.device)
    model_tags = extract_tag_model_fiducials(TagDB.get_instance(args.db))
    if not model_tags:
        print("no tag models with fiducial crops in the database",
              file=sys.stderr)
        return 1

    a_lo, a_hi, a_step = _parse_range(args.angles)
    s_lo, s_hi, s_step = _parse_range(args.scales)
    os.makedirs(args.model_dir, exist_ok=True)

    class_ids = []
    for tag in model_tags:
        model_img = _load_image(tag.model_file_name)
        class_id = str(tag.model_id)
        for tag_field_id, (x, y, w, h) in tag.crops:
            crop_img = model_img[y:y + h, x:x + w].copy()
            # the crop is stored next to the model image and is the source
            # the match-time fiducial gate re-renders from
            # (test_jabil.cpp:70-76)
            fid_path = fiducial_crop_path(tag.model_file_name, tag_field_id)
            viz.save_image(crop_img, fid_path)

            producer = ShapeInfoProducer(
                crop_img, None,
                angle_range=[a_lo] if a_hi <= a_lo else [a_lo, a_hi],
                scale_range=[s_lo] if s_hi <= s_lo else [s_lo, s_hi],
                angle_step=a_step, scale_step=s_step)
            infos = producer.produce_infos()
            # batches per crop (equal to per-info add_template;
            # createLinemod2DTemplates' inner loop, test_jabil.cpp:84-100)
            tids = add_sweep(
                det, [producer.src_of(i) for i in infos], class_id,
                [producer.mask_of(i) for i in infos],
                sscales=[i.scale for i in infos],
                orientations=[i.angle for i in infos],
                tag_field_ids=[tag_field_id] * len(infos),
                fiducial_src=fid_path)
            for tid in tids:
                if tid == -1:
                    print(f"Could not create template with ID:{tid}")
        class_ids.append(class_id)
        print(f"Writing template for model: {tag.model_name}")
        det.write_classes(os.path.join(args.model_dir, "%s.yaml.gz"))

    det.save_settings(os.path.join(args.model_dir, "detector_linemod.yaml"),
                      templates_dir=os.path.abspath(args.model_dir),
                      classes=class_ids)
    print(f"saved {det.num_templates()} templates over "
          f"{len(class_ids)} classes to {args.model_dir}")
    return 0


def cmd_match_db(args) -> int:
    """DB-driven batch match (test_jabil.cpp:120-310
    detectTemplateLinemod): bootstrap the detector singleton from the
    saved settings, match every image, NMS, and gate each match with the
    stored-fiducial CCORR check against its database model."""
    from .db import TagDB, extract_tag_model_fiducials
    from .models.detector import get_instance
    from .utils import viz
    from .utils.profiling import recording
    from .utils.timer import CSVStat

    model_tags = {t.model_id: t for t in
                  extract_tag_model_fiducials(TagDB.get_instance(args.db))}
    det = get_instance(
        os.path.join(args.model_dir, "detector_linemod.yaml"),
        device=args.device)
    stride = det.T_at_level[-1] * (2 ** (det.pyramid_levels - 1))
    if args.verify_ccorr > 0:
        _register_fiducials(det, lambda class_id, t0: (
            t0.fiducial_src if os.path.exists(t0.fiducial_src or "")
            else None))

    paths = _images(args.test_dir)
    if not paths:
        print(f"no images in {args.test_dir}", file=sys.stderr)
        return 1

    stats = CSVStat(["MATCH", "NMS", "HCORR"])
    for path in paths:
        img = crop_to_stride(_load_image(path, gray=args.gray), stride)
        n0 = det.counters["matches"]
        with recording() as rec:
            results = det.inspect(img, args.threshold, nms=args.nms,
                                  ccorr=args.verify_ccorr)
        n_matches = det.counters["matches"] - n0
        stage = _stages(rec)
        kept = []
        for r in results:
            if int(r.match.class_id) not in model_tags:
                print(f"Model '{r.match.class_id}' non-existent")
                break
            if r.passed:
                kept.append(r.match)

        stats.append(stage)
        print(f"{os.path.basename(path)}: {n_matches} matches, "
              f"{len(kept)} after NMS/verify "
              f"[match {stage[0]:.1f} ms]")
        for m in kept[: args.top_k]:
            t0 = det.get_templates(m.class_id, m.template_id)[0]
            name = model_tags[int(m.class_id)].model_name
            print(f"  model={name} class={m.class_id} tid={m.template_id} "
                  f"x={m.x} y={m.y} sim={m.similarity:.2f} "
                  f"scale={t0.sscale:.2f} angle={int(t0.orientation)}")
        if args.annotate:
            os.makedirs(args.annotate, exist_ok=True)
            out = viz.draw_matches(img, kept, det)
            viz.save_image(out, os.path.join(
                args.annotate, os.path.basename(path) + ".match.png"))

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(stats.summary_csv() + "\n")
        print(f"timing summary -> {args.csv}")
    return 0


def cmd_preprocess(args) -> int:
    """Contrast-enhancement preview (test_old.cpp:277-334 test_preprocess):
    crop to 16n, halve, gray, CLAHE(clip, tiles) or equalizeHist, and save
    the gray|enhanced side-by-side image (imshow replaced by file output)."""
    from .utils import viz
    from .utils.cv_resize import resize_linear_u8
    from .utils.preprocess import clahe, equalize_hist
    from .utils.timer import Timer
    from .utils.verify import bgr2gray_u8

    paths = _images(args.test_dir)
    if not paths:
        print(f"no images in {args.test_dir}", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    for path in paths:
        timer = Timer()
        img = crop_to_stride(_load_image(path), 16)
        img = resize_linear_u8(img, 0.5, 0.5)
        gray = bgr2gray_u8(img) if img.ndim == 3 else img
        if args.mode == "clahe":
            enhanced = clahe(gray, args.clip, (args.tiles, args.tiles))
        else:
            enhanced = equalize_hist(gray)
        out = np.concatenate([gray, enhanced], axis=1)  # cv::hconcat
        out_path = os.path.join(args.out_dir,
                                os.path.basename(path) + ".preproc.png")
        viz.save_image(out, out_path)
        timer.out(f"{os.path.basename(path)} ({args.mode})")
    return 0


def _rotated_rect_points(center, size, angle_deg):
    """cv::RotatedRect::points replica: 4 corners of a center/size box
    rotated by `angle_deg` (OpenCV's clockwise convention)."""
    import math

    cx, cy = float(center[0]), float(center[1])
    w, h = float(size[0]), float(size[1])
    rad = angle_deg * math.pi / 180.0
    b = math.cos(rad) * 0.5
    a = math.sin(rad) * 0.5
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (2 * cx - p0[0], 2 * cy - p0[1])
    p3 = (2 * cx - p1[0], 2 * cy - p1[1])
    return [p0, p1, p2, p3]


def _pad_image(img: np.ndarray, padding: int) -> np.ndarray:
    """Zero-pad all four borders (test.cpp:273-279,344-347)."""
    widths = ((padding, padding), (padding, padding)) + \
        (((0, 0),) if img.ndim == 3 else ())
    return np.pad(img, widths, mode="constant")


def _demo_matches_json(matches, path: str) -> None:
    rows = [{"class_id": m.class_id, "template_id": int(m.template_id),
             "x": int(m.x), "y": int(m.y),
             "similarity": float(m.similarity)} for m in matches]
    with open(path, "w") as f:
        json.dump(rows, f, indent=2)


def _demo_train(args, det, shapes, class_id: str, img, rotate_all: bool):
    """Train mode of the angle and noise demos: the first info by
    add_template, the rest by add_template_rotate when `rotate_all`
    (re-rendered by add_template otherwise), then the class YAML and the
    infos (test.cpp:262-420, :422-528)."""
    from .models.shape_info import ShapeInfoProducer

    infos_have_templ = []
    first_id, first_angle = 0, 0.0
    is_first = True
    for info in shapes.infos:
        if is_first or not rotate_all:
            tid = det.add_template(shapes.src_of(info), class_id,
                                   shapes.mask_of(info))
            first_id, first_angle = tid, info.angle
            is_first = False
        else:
            tid = det.add_template_rotate(
                class_id, first_id, info.angle - first_angle,
                (img.shape[1] / 2.0, img.shape[0] / 2.0))
        print(f"templ_id: {tid} (angle {info.angle:.1f})")
        if tid != -1:
            infos_have_templ.append(info)
    det.write_classes(os.path.join(args.out, "%s_templ.yaml"))
    ShapeInfoProducer.save_infos(
        infos_have_templ, os.path.join(args.out, f"{class_id}_info.yaml"))
    print("train end")
    return 0


def cmd_demo(args) -> int:
    """Upstream demo suite (test.cpp:162-555 scale/angle/noise tests),
    headless: annotated results and match lists are written to --out
    instead of imshow. --data points at a checkout of the reference's
    test/ directory (committed template YAMLs + images)."""
    from .models.detector import Detector
    from .models.shape_info import ShapeInfoProducer
    from .utils import viz
    from .utils.nms import nms_boxes
    from .utils.timer import Timer

    case_dir = os.path.join(args.data, args.case)
    if not os.path.isdir(case_dir):
        print(f"no such case directory: {case_dir}", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.RandomState(7)

    def rand_color():
        return tuple(int(c) for c in rng.randint(100, 255, 3))

    if args.case == "case0":
        # scale_test (test.cpp:162-260): circle over a 0.1..1.0 scale sweep.
        det = Detector(num_features=150, T=(4, 8), device=args.device)
        if args.mode == "train":
            img = _load_image(os.path.join(case_dir, "templ/circle.png"),
                              gray=args.gray)
            shapes = ShapeInfoProducer(img)
            shapes.scale_range = [0.1, 1.0]
            shapes.scale_step = 0.01
            shapes.produce_infos()
            infos_have_templ = []
            for info in shapes.infos:
                tid = det.add_template(shapes.src_of(info), "circle",
                                       shapes.mask_of(info),
                                       num_features=int(150 * info.scale))
                print(f"templ_id: {tid} (scale {info.scale:.2f})")
                if tid != -1:
                    infos_have_templ.append(info)
            det.write_classes(os.path.join(args.out, "%s_templ.yaml"))
            ShapeInfoProducer.save_infos(
                infos_have_templ, os.path.join(args.out, "circle_info.yaml"))
            print("train end")
            return 0
        det.read_classes(["circle"], os.path.join(case_dir, "%s_templ.yaml"))
        img = crop_to_stride(
            _load_image(os.path.join(case_dir, args.image or "1.jpg"),
                        gray=args.gray), 32)
        timer = Timer()
        matches = det.match(img, args.threshold, ["circle"])
        timer.out("match")
        print(f"matches.size(): {len(matches)}")
        ann = viz.Annotator(img)
        for m in matches[:5]:
            t0 = det.get_templates("circle", m.template_id)[0]
            r = t0.width // 2
            color = (255,) + tuple(int(c) for c in rng.randint(0, 255, 2))
            ann.text((m.x + r - 10, m.y - 3), int(round(m.similarity)),
                     color)
            ann.circle((m.x + r, m.y + r), r, color)
            print(f"match.template_id: {m.template_id}  "
                  f"match.similarity: {m.similarity}")
    elif args.case == "case1":
        # angle_test (test.cpp:262-420): one base template + 360 rotations.
        det = Detector(num_features=128, T=(4, 8), device=args.device)
        if args.mode == "train":
            img = _load_image(os.path.join(case_dir, "train.png"),
                              gray=args.gray)
            img = img[110:380, 130:400]  # Rect(130, 110, 270, 270)
            mask = np.full(img.shape[:2], 255, np.uint8)
            img, mask = _pad_image(img, 100), _pad_image(mask, 100)
            shapes = ShapeInfoProducer(img, mask)
            shapes.angle_range = [0.0, 360.0]
            shapes.angle_step = args.angle_step
            shapes.scale_range = [1.0]
            shapes.produce_infos()
            # every info past the first rotates the first template's
            # features when --use-rot (the reference's default)
            return _demo_train(args, det, shapes, "test", img, args.use_rot)
        det.read_classes(["test"], os.path.join(case_dir, "%s_templ.yaml"))
        infos = ShapeInfoProducer.load_infos(
            os.path.join(case_dir, "test_info.yaml"))
        img = crop_to_stride(_pad_image(
            _load_image(os.path.join(case_dir, "test.png"),
                        gray=args.gray), 250), 16)
        timer = Timer()
        matches = det.match(img, args.threshold, ["test"])
        timer.out("match")
        print(f"matches.size(): {len(matches)}")
        ann = viz.Annotator(img)
        for m in matches[:1]:
            t0 = det.get_templates("test", m.template_id)[0]
            info = infos[m.template_id]
            r_scaled = 270 / 2.0 * info.scale
            # center of the training image inside the test frame
            # (270 = trained ROI width, 100 = training padding)
            x = m.x - t0.tl_x + 270 / 2.0 + 100
            y = m.y - t0.tl_y + 270 / 2.0 + 100
            color = rand_color()
            for f in t0.features:
                ann.circle((f.x + m.x, f.y + m.y), 3, color, fill=True)
            ann.text((m.x + r_scaled - 10, m.y - 3),
                     int(round(m.similarity)), color)
            pts = _rotated_rect_points((x, y), (2 * r_scaled, 2 * r_scaled),
                                       -info.angle)
            for i in range(4):
                ann.line(pts[i], pts[(i + 1) % 4], color)
            print(f"match.template_id: {m.template_id}  "
                  f"match.similarity: {m.similarity}  "
                  f"angle: {info.angle}")
    else:
        # noise_test (test.cpp:422-528): multi-instance + detection NMS.
        det = Detector(num_features=30, T=(4, 8), device=args.device)
        if args.mode == "train":
            img = _load_image(os.path.join(case_dir, "train.png"),
                              gray=args.gray)
            mask = np.full(img.shape[:2], 255, np.uint8)
            shapes = ShapeInfoProducer(img, mask)
            shapes.angle_range = [0.0, 360.0]
            shapes.angle_step = args.angle_step
            shapes.produce_infos()
            # this fork's transform() only re-renders exact-90 rotations
            # (line2Dup.h:398-402), so --use-rot (feature rotation) is
            # the default for arbitrary angles, as in angle_test.
            return _demo_train(args, det, shapes, "test", img, args.use_rot)
        det.read_classes(["test"], os.path.join(case_dir, "%s_templ.yaml"))
        img = crop_to_stride(
            _load_image(os.path.join(case_dir, "test.png"), gray=args.gray),
            16)
        timer = Timer()
        matches = det.match(img, args.threshold, ["test"])
        timer.out("match")
        print(f"matches.size(): {len(matches)}")
        keep = nms_boxes(*_boxes(det, matches), 0.0, 0.5)
        ann = viz.Annotator(img)
        kept = []
        for idx in keep:
            m = matches[idx]
            t0 = det.get_templates("test", m.template_id)[0]
            color = rand_color()
            for f in t0.features:
                ann.circle((f.x + m.x, f.y + m.y), 2, color, fill=True)
            r = t0.width // 2
            ann.text((m.x + r - 10, m.y - 3), int(round(m.similarity)),
                     color)
            ann.rect((m.x, m.y, t0.width, t0.height), color)
            kept.append(m)
            print(f"match.template_id: {m.template_id}  "
                  f"match.similarity: {m.similarity}")
        matches = kept

    result_path = os.path.join(args.out, f"{args.case}_result.png")
    ann.save(result_path)
    _demo_matches_json(
        matches, os.path.join(args.out, f"{args.case}_matches.json"))
    print(f"result: {result_path}")
    return 0


def _nvidia_smi() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.stdout.strip() or out.stderr.strip()


def cmd_info(args) -> int:
    """Compute-backend self-report (the MIPP_test analog,
    test.cpp:526-547: instruction set, register width, int8 op support --
    here: torch and CUDA, the device, whether the kernels are built, and
    the launch choices the port makes for the given configuration)."""
    import torch

    from .models import native
    from .ops.chain_plan import plan_chain
    from .ops.cuda import build
    from .ops.cuda.coarse import coarse_split
    from .ops.cuda.frontend import frontend_split
    from .ops.cuda.refine import refine_split
    from .ops.similarity import LevelBank
    from .utils.synthetic import build_rotated_detector

    dev = torch.device(args.device)
    print("shape_based_matching_tpu_torch backend report")
    print("---------------------------------------------")
    print(f"torch version:      {torch.__version__} "
          f"(CUDA {torch.version.cuda or 'none'})")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but CUDA is not available")
        print(f"device:             {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(dev)}")
        print(f"nvidia-smi:         {_nvidia_smi()}")
    else:
        print(f"device:             {dev} (every kernel runs its plain "
              f"PyTorch twin)")
    kernels = build.library_path()
    print(f"CUDA kernels:       "
          f"{'built' if os.path.isfile(kernels) else 'not built'} "
          f"({os.path.basename(kernels)})")
    host = native.library_path()
    print(f"host helpers:       "
          f"{'built' if os.path.isfile(host) else 'not built'} "
          f"({os.path.basename(host)})")

    h, w = (int(v) for v in args.size.split("x"))
    T = tuple(int(t) for t in args.T.split(","))
    n_ori = int(args.n_ori)
    nfeat = int(args.num_features)
    det, _ = build_rotated_detector(num_templates=args.templates,
                                    num_features=nfeat, T=T, n_ori=n_ori,
                                    device=dev)
    det._validate_size((h, w))
    sizes = det._level_sizes((h, w))
    banks = det._get_banks("bench")
    print(f"\nconfig {w}x{h}, T={T}, n_ori={n_ori}, {nfeat} features, "
          f"{args.templates} rotated templates:")
    for l, ((lw, lh), t) in enumerate(zip(sizes, T)):
        print(f"  frontend level {l}:  {frontend_split(1, lh, lw, t)} rows "
              f"a warp at B=1 ({frontend_split(8, lh, lw, t)} at B=8)")
    K, N = banks[-1].fx.shape
    (lw, lh), t = sizes[-1], T[-1]
    M = (lw // t) * (lh // t)
    G, chunk = coarse_split(1, K, N, M)
    print(f"  coarse.cu:        K={K} N={N} M={M}: {G} slot group(s) of "
          f"{chunk}")
    plan = plan_chain(LevelBank(*(f.cpu().numpy() for f in banks[-1])),
                      T[-1], sizes[-1], n_ori)
    print(f"  chain planner:    "
          f"{'declines (coarse.cu)' if plan is None else 'takes the bank (chain.cu, %d programs)' % (len(plan.prog_start) - 1)}")
    N0 = banks[0].fx.shape[1]
    CB, G0, chunk0 = refine_split(N0)
    print(f"  refine.cu:        N={N0}: "
          f"{'window_kernel' if G0 == 1 and CB == 1 else 'cluster_kernel'}"
          f" ({CB} candidate(s) a block, {G0} feature group(s) of "
          f"{chunk0})")

    if args.dispatch:
        _dispatch_audit(dev)
    return 0


def _dispatch_audit(dev) -> None:
    """Device work and synchronizing calls of one warm B=1 match (256x256,
    4 templates) through utils/profiling.py: separates a slow host from a
    code change that grew the launches. The count is of the host-side
    CUDA calls that queued device work (kernels, memsets, copies), which
    the profiler records completely where its device side can lose
    events."""
    from .utils import profiling
    from .utils.synthetic import build_rotated_detector, synthetic_scene

    det, templ_img = build_rotated_detector(num_templates=4, num_features=32,
                                            size=56, device=dev)
    scene = synthetic_scene(256, 256, templ_img, n_instances=2, seed=5)
    det.match(scene, 80.0)  # first launches, banks and plans
    print("\nwarm B=1 match dispatch audit (256x256, 4 templates):")
    if dev.type != "cuda":
        print("  device kernels           not measured (no card)")
        return
    queued, events = profiling.device_work(lambda: det.match(scene, 80.0))
    _, syncs = profiling.sync_calls(lambda: det.match(scene, 80.0))
    print(f"  device work a call       {queued / profiling.CALLS:g}")
    print(f"  device ms a call         "
          f"{sum(ms for _, ms in events) / profiling.CALLS:.4f}")
    print(f"  synchronizing calls      {syncs}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="shape_based_matching_tpu_torch",
        description="LINE-2D shape-based matching on PyTorch and CUDA")
    ap.add_argument("--device", default="cuda",
                    help="where frames, banks and kernels run: cuda (the "
                         "default; raises without a card) or cpu (the "
                         "kernels' plain PyTorch twins)")
    ap.add_argument(
        "--trace", metavar="DIR",
        help="wrap the command in torch.profiler and write a Chrome trace "
             "to DIR/trace.json (the deep-dive layer behind the Timer "
             "CSVs; reference analog is the per-stage Timer at "
             "test_jabil.cpp:127-310)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="create templates (jabil -c mode)")
    tr.add_argument("--model-dir", required=True)
    tr.add_argument("--class-id", required=True)
    tr.add_argument("--image", required=True)
    tr.add_argument("--mask")
    tr.add_argument("--angles", default="0",
                    help="comma list; only multiples of 90 re-render pixels")
    tr.add_argument("--scales", default="1.0", help="lo:hi:step or single")
    tr.add_argument("--num-features", type=int, default=63)
    tr.add_argument("--weak", type=float, default=30.0)
    tr.add_argument("--strong", type=float, default=60.0)
    tr.add_argument("--T", default="4,8")
    tr.add_argument("--gray", action="store_true")
    tr.set_defaults(fn=cmd_train)

    ma = sub.add_parser("match", help="batch match a directory (jabil -t)")
    ma.add_argument("--model-dir", required=True)
    ma.add_argument("--test-dir", required=True)
    ma.add_argument("--threshold", type=float, default=90.0)
    ma.add_argument("--nms", type=float, default=0.5)
    ma.add_argument("--verify-ccorr", type=float, default=0.0,
                    help="TM_CCORR_NORMED gate (jabil uses 0.8; 0 disables)")
    ma.add_argument("--top-k", type=int, default=10)
    ma.add_argument("--csv", help="write min/max/mean stage timings CSV")
    ma.add_argument("--annotate", help="directory for annotated outputs")
    ma.add_argument("--debug", action="store_true",
                    help="dump quantized-orientation images")
    ma.add_argument("--gray", action="store_true")
    ma.add_argument("--spatial-shards", type=int, default=0,
                    help="row-shard each frame over N devices "
                         "(parallel/spatial.py; 0 = single device)")
    ma.add_argument("--icp", action="store_true",
                    help="subpixel sim2 pose refinement per kept match "
                         "(models/icp.py)")
    ma.set_defaults(fn=cmd_match)

    tdb = sub.add_parser(
        "train-db", help="create templates from the tag DB (jabil -c)")
    tdb.add_argument("--db", required=True, help="SQLite tag database")
    tdb.add_argument("--model-dir", default="model_images")
    tdb.add_argument("--num-features", type=int, default=150)
    tdb.add_argument("--weak", type=float, default=100.0)
    tdb.add_argument("--strong", type=float, default=200.0)
    tdb.add_argument("--T", default="4,8")
    tdb.add_argument("--angles", default="0:270:90",
                     help="lo:hi:step (reference: 0..270 step 90)")
    tdb.add_argument("--scales", default="0.9:1.1:0.1",
                     help="lo:hi:step (reference: 0.9..1.1 step 0.1)")
    tdb.set_defaults(fn=cmd_train_db)

    mdb = sub.add_parser(
        "match-db", help="batch match with DB model lookup (jabil -t)")
    mdb.add_argument("--db", required=True, help="SQLite tag database")
    mdb.add_argument("--model-dir", default="model_images")
    mdb.add_argument("--test-dir", required=True)
    mdb.add_argument("--threshold", type=float, default=90.0)
    mdb.add_argument("--nms", type=float, default=0.5)
    mdb.add_argument("--verify-ccorr", type=float, default=0.8,
                     help="TM_CCORR_NORMED gate (reference: 0.8; 0 disables)")
    mdb.add_argument("--top-k", type=int, default=10)
    mdb.add_argument("--csv", help="write min/max/mean stage timings CSV")
    mdb.add_argument("--annotate", help="directory for annotated outputs")
    mdb.add_argument("--gray", action="store_true")
    mdb.set_defaults(fn=cmd_match_db)

    pp = sub.add_parser("preprocess",
                        help="CLAHE/equalizeHist preview (test_old.cpp)")
    pp.add_argument("--test-dir", required=True)
    pp.add_argument("--out-dir", required=True)
    pp.add_argument("--mode", choices=("clahe", "eqhist"), default="clahe")
    pp.add_argument("--clip", type=float, default=40.0,
                    help="CLAHE clip limit (reference uses 40)")
    pp.add_argument("--tiles", type=int, default=8,
                    help="CLAHE tile grid (reference uses 8x8)")
    pp.set_defaults(fn=cmd_preprocess)

    dm = sub.add_parser(
        "demo", help="upstream demo suite (test.cpp scale/angle/noise)")
    dm.add_argument("case", choices=("case0", "case1", "case2"))
    dm.add_argument("--data", required=True,
                    help="directory containing case0/ case1/ case2/ "
                         "(the reference's test/ tree)")
    dm.add_argument("--out", required=True, help="output directory")
    dm.add_argument("--mode", choices=("test", "train"), default="test")
    dm.add_argument("--threshold", type=float, default=90.0)
    dm.add_argument("--image", help="case0 test image name (default 1.jpg)")
    dm.add_argument("--angle-step", type=float, default=1.0,
                    help="train-mode rotation step (committed YAMLs use 1)")
    dm.add_argument("--use-rot", action="store_true", default=True,
                    help="derive rotations via addTemplate_rotate")
    dm.add_argument("--no-use-rot", dest="use_rot", action="store_false")
    dm.add_argument("--gray", action="store_true")
    dm.set_defaults(fn=cmd_demo)

    inf = sub.add_parser(
        "info", help="backend / kernel-selection report (MIPP_test analog)")
    inf.add_argument("--size", default="1024x1024", help="HxW, e.g. 1024x1024")
    inf.add_argument("--T", default="4,8")
    inf.add_argument("--n-ori", default="8")
    inf.add_argument("--num-features", default="63")
    inf.add_argument("--templates", type=int, default=1000,
                     help="rotated templates of the synthetic bank whose "
                          "launch choices are reported")
    inf.add_argument("--dispatch", action="store_true",
                     help="audit device work and synchronizing calls "
                          "of one warm match")
    inf.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    if args.trace:
        return _traced(args)
    return args.fn(args)


def _traced(args) -> int:
    """Run the command under torch.profiler (the CPU, and the card when
    the command runs there) and write DIR/trace.json."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if args.device != "cpu" and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.trace, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        rc = args.fn(args)
    prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
