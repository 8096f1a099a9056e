"""Feature / Template data model (mirror of line2Dup.h:116-153).

Plain Python dataclasses on the host; packed into `LevelBank` tensors
(ops/similarity.py) before anything touches the device. ``crop_templates``
is training's bounding-box crop. ``to_yaml`` / ``from_yaml`` are the
reference's Template::write / read (line2Dup.cpp:86-113) with the ddcr
fork's fields, in the JAX package's key order; ``theta`` is not stored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class Feature:
    x: int = 0
    y: int = 0
    label: int = 0
    theta: float = 0.0  # raw gradient angle in degrees (not serialized)

    def to_yaml(self):
        return [int(self.x), int(self.y), int(self.label)]

    @classmethod
    def from_yaml(cls, seq) -> "Feature":
        return cls(int(seq[0]), int(seq[1]), int(seq[2]))


@dataclass
class Template:
    width: int = 0
    height: int = 0
    tl_x: int = 0
    tl_y: int = 0
    pyramid_level: int = 0
    features: List[Feature] = field(default_factory=list)
    # ddcr fork metadata (line2Dup.h:140-148)
    sscale: float = 0.0
    orientation: float = 0.0
    tag_field_id: int = 0
    fiducial_src: str = ""

    def to_yaml(self) -> dict:
        return {
            "width": int(self.width),
            "height": int(self.height),
            "tl_x": int(self.tl_x),
            "tl_y": int(self.tl_y),
            "scale": float(self.sscale),
            "orientation": float(self.orientation),
            "tagFieldID": int(self.tag_field_id),
            "fiducial_src": self.fiducial_src,
            "pyramid_level": int(self.pyramid_level),
            "features": [[int(f.x), int(f.y), int(f.label)]
                         for f in self.features],
        }

    @classmethod
    def from_yaml(cls, node: dict) -> "Template":
        # cv::FileNode defaults for absent keys: 0 / 0.0 / "".
        return cls(
            width=int(node.get("width", 0)),
            height=int(node.get("height", 0)),
            tl_x=int(node.get("tl_x", 0)),
            tl_y=int(node.get("tl_y", 0)),
            pyramid_level=int(node.get("pyramid_level", 0)),
            features=[Feature(int(x), int(y), int(label))
                      for x, y, label in node.get("features", [])],
            sscale=float(node.get("scale", 0.0) or 0.0),
            orientation=float(node.get("orientation", 0.0) or 0.0),
            tag_field_id=int(node.get("tagFieldID", 0) or 0),
            fiducial_src=str(node.get("fiducial_src", "") or ""),
        )


TemplatePyramid = List[Template]  # one Template per pyramid level


def crop_templates(tp: TemplatePyramid) -> tuple:
    """Tighten the bounding box over all levels (line2Dup.cpp:115-161).

    Feature positions are scaled by << pyramid_level, the min corner is
    forced even, and features are rebased. Returns (min_x, min_y, w, h) at
    level 0. Mutates `tp` in place.
    """
    min_x = min_y = 1 << 30
    max_x = max_y = -(1 << 30)
    for t in tp:
        for f in t.features:
            x = f.x << t.pyramid_level
            y = f.y << t.pyramid_level
            min_x = min(min_x, x)
            min_y = min(min_y, y)
            max_x = max(max_x, x)
            max_y = max(max_y, y)
    # C-style remainder: the reference's `min_x % 2 == 1` is FALSE for
    # negative odd values (C gives -1), so rotated templates crossing the
    # origin keep an odd min corner. Python's % would wrongly decrement.
    if min_x >= 0 and min_x % 2 == 1:
        min_x -= 1
    if min_y >= 0 and min_y % 2 == 1:
        min_y -= 1
    for t in tp:
        l = t.pyramid_level
        t.width = (max_x - min_x) >> l
        t.height = (max_y - min_y) >> l
        t.tl_x = min_x >> l
        t.tl_y = min_y >> l
        for f in t.features:
            f.x -= t.tl_x
            f.y -= t.tl_y
    return (min_x, min_y, max_x - min_x, max_y - min_y)
