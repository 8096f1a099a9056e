"""The fork's fiducial inspection (test_jabil.cpp:121-312) as one library
call: match, greedy NMS per frame, and the stored-fiducial CCORR gate.

``Detector.inspect_batch(frames, threshold, nms=0.5, ccorr=0.8)`` (and
``inspect`` at B=1) uploads the frames once (to a card through a
page-locked buffer the detector keeps, ``_upload``) and runs:

1. ``match_batch`` at the threshold;
2. per frame, ``utils/nms.nms_boxes(boxes, scores, 0.0, nms)`` over the
   list in ``_sort_dedup``'s order, the boxes being the templates'
   (x, y, width, height): on the host, order-dependent and small;
3. the gate (``ccorr`` > 0) of every NMS-kept match whose template has a
   registered fiducial (``Detector.set_fiducial``): the template's
   reference crop (``utils/verify.fiducial_reference``, built once per
   template and cached on the detector) against the matched crop of the
   frame's gray conversion, both min-max normalized to u8, and
   TM_CCORR_NORMED >= ccorr. On the frames' device, over all kept
   matches of the call at once (``ccorr_batch``); its plain twin is
   ``utils/verify.verify_match_fiducial`` a match (``_gate_plain``).

It returns, per frame, every NMS-kept match as an ``Inspected``: its
float32 CCORR score (NaN where no gate ran) and whether it passed (always
where no gate ran). The caller's list is the passed ones.

The batched gate gives the plain gate's float32 bits: the normalized
crops are integers, so the numerator and both energies are sums of
integers under 2^53, exact in float64 in any order, and the score is
``float32(num / max(sqrt(e1 * e2), 1e-12))`` in float64, as
``match_template_ccorr_normed`` computes it; the normalization is
``rint((a - mn) * (255 / (mx - mn)))`` in separate float64 roundings. A flat crop normalizes to zeros and scores 0; a box
that leaves the frame, or a template rect that leaves its transformed
fiducial, gives (False, 0.0).

**Spans and counters.** ``sbm.inspect`` (root: B, classes) holds
``match_batch``'s own spans, ``sbm.inspect.nms`` (matches in, kept) and
``sbm.inspect.gate`` (route ``batched``, M, passed), after
``sbm.inspect.upload`` (bytes, route ``staged`` or ``direct``). ``Detector.counters`` counts
``inspect.frames``, ``inspect.gated`` (matches the gate scored) and
``inspect.rejected`` (those it failed).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.nms import nms_boxes
from ..utils.profiling import span
from ..utils.verify import (bgr2gray_u8, fiducial_reference,
                            verify_match_fiducial)
from .detector import Match


@dataclass
class Inspected:
    """An NMS-kept match and its gate: `ccorr` is the float32
    TM_CCORR_NORMED score (NaN where no gate ran), `passed` whether the
    match is kept."""

    match: Match
    ccorr: float
    passed: bool


class GateBank(NamedTuple):
    """The gate's reference crops of every template with a fiducial, on
    the device: row `rows[(class_id, template_id)]` of `refs` (float64
    [N, H, W], integers, zero past the template's height and width) with
    its sum of squares `energy` (float64 [N], exact); `fits[row]` is
    False where the template rect leaves its transformed fiducial (its
    row is zeros); `consts` is float64 (3735, 19235, 9798, 255): the gray
    conversion's weights and the normalization's range."""

    rows: dict
    refs: torch.Tensor
    energy: torch.Tensor
    fits: np.ndarray
    consts: torch.Tensor


def _fiducial(det, class_id: str, template_id: int):
    """The fiducial image registered for a template, or None."""
    fids = det._fiducials.get(class_id, {})
    return fids.get(template_id, fids.get(None))


def gate_bank(det) -> GateBank:
    """The detector's ``GateBank``, built at first need after a class or a
    fiducial changes (``Detector._invalidate`` and ``set_fiducial`` drop
    it): every registered template's crop, then the device tensors."""
    if det._gate_bank is not None:
        return det._gate_bank
    keys, crops = [], []
    for class_id in det._fiducials:
        for tid, tp in enumerate(det.class_templates.get(class_id, [])):
            img = _fiducial(det, class_id, tid)
            if img is not None:
                keys.append((class_id, tid))
                crops.append(fiducial_reference(tp[0], img))
    live = [c for c in crops if c is not None]
    refs = np.zeros((len(keys), max((c.shape[0] for c in live), default=0),
                     max((c.shape[1] for c in live), default=0)), np.float64)
    for i, c in enumerate(crops):
        if c is not None:
            refs[i, :c.shape[0], :c.shape[1]] = c
    refs_t = torch.from_numpy(refs)
    det._gate_bank = GateBank(
        {k: i for i, k in enumerate(keys)}, refs_t.to(det.device),
        (refs_t ** 2).sum((1, 2)).to(det.device),
        np.array([c is not None for c in crops], bool),
        torch.tensor([3735.0, 19235.0, 9798.0, 255.0], dtype=torch.float64,
                     device=det.device))
    return det._gate_bank


def ccorr_batch(scene: torch.Tensor, fb: torch.Tensor, rows: torch.Tensor,
                cols: torch.Tensor, inside: torch.Tensor, ref: torch.Tensor,
                ref_energy: torch.Tensor,
                consts: torch.Tensor) -> torch.Tensor:
    """TM_CCORR_NORMED of M matched crops against their reference crops,
    float32 [M] on the scene's device. `scene`: uint8 frames, gray [B, H,
    W] or BGR [B, H, W, 3]; `fb`: int64 [M], each crop's frame; `rows`,
    `cols`: int64 [M, Hm] and [M, Wm], each crop's rows and columns of
    its frame, its last one repeated to the tile's size (so that a tile's
    minimum and maximum are its crop's); `inside`: [M, Hm, Wm], 1 on the
    crop and 0 past it; `ref`: float64 [M, Hm, Wm], the normalized
    reference crops, zero past each size; `ref_energy`: float64 [M],
    their sums of squares; `consts`: ``GateBank.consts``. Each crop (its
    gray conversion for BGR) is min-max normalized to u8 as
    ``normalize_minmax_u8`` does (zeros where it is flat)."""
    a = scene[fb[:, None, None], rows[:, :, None], cols[:, None, :]].to(
        torch.float64)
    # every value below is an integer under 2^53 (a sum of at most 255^2
    # a pixel), so float64 holds the crops, their spans and the sums
    # exactly in any order, and the quotients round as numpy's do
    if a.dim() == 4:
        # cvtColor BGR2GRAY: (b 3735 + g 19235 + r 9798 + 2^14) >> 15
        a = torch.floor_divide(a @ consts[:3] + (1 << 14), 1 << 15)
    a = a.flatten(1)
    mn, mx = torch.aminmax(a, dim=1, keepdim=True)
    # a tensor over a tensor: torch takes 255.0 / d as 255.0 * (1 / d),
    # which rounds apart from numpy's quotient for d = 14, 28, 50, ...
    scale = consts[3:] / (mx - mn).clamp(min=1.0)
    # (a - mn) * scale is at most 255 (1 + 2^-52): rounding keeps it in
    # u8; a flat crop gives zeros
    norm = torch.round((a - mn) * scale) * inside.flatten(1)
    num = torch.bmm(norm[:, None], ref.flatten(1)[:, :, None]).flatten()
    energy = torch.bmm(norm[:, None], norm[:, :, None]).flatten()
    den = torch.sqrt(energy * ref_energy)
    return (num / den.clamp_min(1e-12)).to(torch.float32)


def _nms(det, matches: list, nms: float) -> list:
    """The matches that greedy NMS keeps, in its order."""
    boxes, scores = [], []
    for m in matches:
        t0 = det.class_templates[m.class_id][m.template_id][0]
        boxes.append((m.x, m.y, t0.width, t0.height))
        scores.append(m.similarity)
    return [matches[i] for i in nms_boxes(boxes, scores, 0.0, nms)]


def _gate_batched(det, scene: torch.Tensor, todo: list, ccorr: float):
    """(score, passed) of each (frame, Match) in `todo`, whose templates
    all have a row in the gate bank: one upload of the crops' frames,
    rows, columns and bank rows, the scores on the device, one
    download."""
    bank = gate_bank(det)
    H, W = scene.shape[1], scene.shape[2]
    meta = np.zeros((len(todo), 6), np.int64)
    for i, (b, m) in enumerate(todo):
        t0 = det.class_templates[m.class_id][m.template_id][0]
        meta[i] = (b, m.x, m.y, t0.width, t0.height,
                   bank.rows[(m.class_id, m.template_id)])
    fb, x, y, w, h, row = meta.T
    ok = (bank.fits[row] & (x >= 0) & (y >= 0) & (x + w <= W)
          & (y + h <= H))
    scores = np.zeros(len(todo), np.float32)
    if ok.any():
        Hm, Wm = bank.refs.shape[1], bank.refs.shape[2]
        r, c = np.arange(Hm), np.arange(Wm)
        y0, x0, h0, w0 = (v[ok, None] for v in (y, x, h, w))
        dev = torch.from_numpy(np.concatenate(
            [fb[ok, None], row[ok, None], np.minimum(y0 + r, y0 + h0 - 1),
             np.minimum(x0 + c, x0 + w0 - 1), r < h0, c < w0],
            axis=1, dtype=np.int64)).to(scene.device)
        rows, cols, in_r, in_c = dev[:, 2:].split((Hm, Wm, Hm, Wm), 1)
        scores[ok] = ccorr_batch(
            scene, dev[:, 0], rows, cols, in_r[:, :, None] * in_c[:, None],
            bank.refs[dev[:, 1]], bank.energy[dev[:, 1]],
            bank.consts).cpu().numpy()
    return scores, ok & (scores >= ccorr)


def _gate_plain(det, scene: torch.Tensor, todo: list, ccorr: float):
    """The plain twin of ``_gate_batched``: ``verify_match_fiducial`` a
    match, on the host."""
    frames = scene.cpu().numpy()
    scores = np.zeros(len(todo), np.float32)
    passed = np.zeros(len(todo), bool)
    for i, (b, m) in enumerate(todo):
        gray = frames[b] if frames.ndim == 3 else bgr2gray_u8(frames[b])
        passed[i], scores[i] = verify_match_fiducial(
            gray, (m.x, m.y), det.class_templates[m.class_id][
                m.template_id][0], _fiducial(det, m.class_id, m.template_id),
            ccorr, device="cpu")
    return scores, passed


def inspect_matches(det, frames, lists: list, nms: float = 0.5,
                    ccorr: float = 0.8) -> list:
    """NMS and the gate over given match lists, one a frame of `frames`
    (uint8 gray [B, H, W] or BGR [B, H, W, 3], numpy or a tensor; moved
    to the detector's device when the gate runs): per frame the
    NMS-kept matches as ``Inspected``."""
    with span("sbm.inspect.nms") as sp:
        out = [[Inspected(m, math.nan, True) for m in _nms(det, ms, nms)]
               for ms in lists]
        sp.note(matches=sum(map(len, lists)), kept=sum(map(len, out)))
    if ccorr <= 0:
        return out
    with span("sbm.inspect.gate", route="batched") as sp:
        rows = gate_bank(det).rows
        todo = [(b, r) for b, kept in enumerate(out) for r in kept
                if (r.match.class_id, r.match.template_id) in rows]
        if todo:
            scores, passed = _gate_batched(
                det, _host_tensor(frames).to(det.device),
                [(b, r.match) for b, r in todo], float(ccorr))
            for (_, r), s, p in zip(todo, scores.tolist(), passed.tolist()):
                r.ccorr, r.passed = s, p
        n_passed = sum(r.passed for _, r in todo)
        sp.note(M=len(todo), passed=n_passed)
    det.counters["inspect.gated"] += len(todo)
    det.counters["inspect.rejected"] += len(todo) - n_passed
    return out


def _host_tensor(a) -> torch.Tensor:
    """A tensor as it is; a numpy array as a tensor over its own memory
    where it is C-contiguous and writable (a 5 MP BGR frame's copy costs
    milliseconds), else over a copy."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a)
    return torch.from_numpy(a)


def _upload(det, sources) -> torch.Tensor:
    """The frames on the detector's device. Host frames bound for a card
    go through a page-locked buffer that the detector keeps (one, of the
    shape last staged): torch's host copy into it, on its intra-op
    threads, then an asynchronous copy to the card. (From pageable
    memory CUDA stages through buffers of its own on one thread: 2.4-2.8
    ms for a 5 MP BGR frame on an H100 host, against 0.8-0.9.)"""
    src = _host_tensor(sources)
    dev = torch.device(det.device)
    with span("sbm.inspect.upload", bytes=src.nbytes) as sp:
        if dev.type != "cuda" or src.device.type != "cpu" or src.is_pinned():
            sp.note(route="direct")
            return src.to(dev)
        sp.note(route="staged")
        stage = det._upload_stage
        if (stage is None or stage[0].shape != src.shape
                or stage[0].dtype != src.dtype):
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        else:
            buf, done = stage
            done.synchronize()     # the card has read the last frames
        buf.copy_(src)
        out = buf.to(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))
        det._upload_stage = (buf, done)
        return out


def inspect_batch(det, sources, threshold: float, class_ids=None,
                  nms: float = 0.5, ccorr: float = 0.8) -> list:
    """``Detector.inspect_batch``: the frames uploaded once (``_upload``),
    then ``match_batch`` and ``inspect_matches`` on the device copy."""
    with span("sbm.inspect", B=len(sources),
              classes=len(class_ids or det.class_templates)):
        frames = _upload(det, sources)
        det.counters["inspect.frames"] += frames.shape[0]
        lists = det.match_batch(frames, threshold, class_ids)
        return inspect_matches(det, frames, lists, nms, ccorr)
