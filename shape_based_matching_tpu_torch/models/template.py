"""Feature / Template data model (mirror of line2Dup.h:116-153).

Plain Python dataclasses on the host; packed into `LevelBank` tensors
(ops/similarity.py) before anything touches the device. YAML I/O and the
training-time crop are not part of the match path and are not ported yet.
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


TemplatePyramid = List[Template]  # one Template per pyramid level
