"""Plant-database bridge — the Persistence/DAOWrapper capability, TPU-repo way.

The reference's jabil driver pulls tag models and their fiducial crops from a
Qt/SQL plant database through a DAOWrapper singleton
(utils.cpp:66-111 ``extractTagModelFiducialsFromDB``, dao_wrapper.hpp — the
Persistence submodule itself is absent from the reference mount). This module
re-creates that capability on the Python stdlib: an SQLite schema with the
same entities (TagModel, TagModelField, TagField), the same accessor surface
(``get_all_tag_models`` / ``get_tag_field``), the same JSON
``geometricalInfo`` position format (utils.cpp:41-64 ``parsePositions``),
and the same extraction/validation flow.

Nothing here touches the device: the DB layer only produces ``ModelTag``
descriptors that the CLI (``train-db`` / ``match-db``) feeds into the
Detector exactly like test_jabil.cpp:47-118 / :120-240 do. Image sizes
come from ``utils/imageio.py`` (PNG and PGM/PPM headers without an image
library).
"""

from __future__ import annotations

import json
import os
import sqlite3
from dataclasses import dataclass, field


# Fiducial markers are tag fields of this type (utils.cpp:87).
FIDUCIAL_FIELD_TYPE = 3


@dataclass
class BBox:
    """Parsed geometricalInfo box (common_structs BBox; utils.cpp:49-62)."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0
    x_pixels: int = 0
    y_pixels: int = 0
    width_pixels: int = 0
    height_pixels: int = 0
    w_image: int = 0
    h_image: int = 0


@dataclass
class ModelTag:
    """One tag model and its fiducial crops (utils.cpp:66-111)."""

    model_id: int
    model_file_name: str
    image_size: tuple[int, int]  # (width, height)
    model_name: str
    # [(tag_field_id, (x, y, width, height)), ...]
    crops: list[tuple[int, tuple[int, int, int, int]]] = field(
        default_factory=list)


def parse_positions(json_str: str, image_size: tuple[int, int]) -> BBox:
    """Replica of parsePositions (utils.cpp:41-64).

    The DB stores every value as a string; the normalized X/Y/width/height
    floats are scaled by the image size and truncated with the C ``int()``
    cast (the reference notes "maybe should be ceil()" and does not).
    """
    try:
        obj = json.loads(json_str)
    except (TypeError, json.JSONDecodeError):
        obj = {}
    if not obj:
        raise ValueError("BBox Json Empty!")
    w_img, h_img = image_size

    def f(key):  # QJsonValue.toString().toFloat(): missing/bad -> 0.0
        try:
            return float(obj.get(key, "0"))
        except (TypeError, ValueError):
            return 0.0

    def i(key):  # .toInt()
        try:
            return int(float(obj.get(key, "0")))
        except (TypeError, ValueError):
            return 0

    return BBox(
        x=int(f("X") * w_img),
        y=int(f("Y") * h_img),
        width=int(f("width") * w_img),
        height=int(f("height") * h_img),
        x_pixels=i("X_pixels"),
        y_pixels=i("Y_pixels"),
        width_pixels=i("width_pixels"),
        height_pixels=i("height_pixels"),
        w_image=i("w_image"),
        h_image=i("h_image"),
    )


_SCHEMA = """
CREATE TABLE IF NOT EXISTS tag_model (
    tag_model_id  INTEGER PRIMARY KEY,
    name          TEXT NOT NULL,
    ref_image_url TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS tag_field (
    tag_field_id      INTEGER PRIMARY KEY,
    name              TEXT NOT NULL,
    tag_field_type_id INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS tag_model_field (
    tag_model_id     INTEGER NOT NULL REFERENCES tag_model(tag_model_id),
    tag_field_id     INTEGER NOT NULL REFERENCES tag_field(tag_field_id),
    geometrical_info TEXT NOT NULL,
    PRIMARY KEY (tag_model_id, tag_field_id)
);
"""


class TagDB:
    """DAOWrapper-shaped accessor over an SQLite tag database.

    Mirrors the reference's singleton surface (``DAOWrapper::getInstance``,
    ``getAllTagModels``, ``getTagField`` — utils.cpp:69-84) so drivers read
    the same way; ``get_instance`` keys the singleton by path.
    """

    _instances: dict[str, "TagDB"] = {}

    def __init__(self, path: str):
        self.path = path
        self._conn = sqlite3.connect(path)
        self._conn.executescript(_SCHEMA)

    @classmethod
    def get_instance(cls, path: str) -> "TagDB":
        key = os.path.abspath(path)
        if key not in cls._instances:
            cls._instances[key] = cls(key)
        return cls._instances[key]

    def close(self) -> None:
        self._conn.close()
        type(self)._instances.pop(os.path.abspath(self.path), None)

    # -- DAO surface ----------------------------------------------------
    def get_all_tag_models(self):
        """[(tag_model_id, name, ref_image_url, [(tag_field_id, geo), ...])]"""
        cur = self._conn.execute(
            "SELECT tag_model_id, name, ref_image_url FROM tag_model "
            "ORDER BY tag_model_id")
        models = []
        for mid, name, url in cur.fetchall():
            fields = self._conn.execute(
                "SELECT tag_field_id, geometrical_info FROM tag_model_field "
                "WHERE tag_model_id = ? ORDER BY tag_field_id",
                (mid,)).fetchall()
            models.append((mid, name, url, fields))
        return models

    def get_tag_field(self, tag_field_id: int):
        """(tag_field_id, name, tag_field_type_id) or None."""
        return self._conn.execute(
            "SELECT tag_field_id, name, tag_field_type_id FROM tag_field "
            "WHERE tag_field_id = ?", (tag_field_id,)).fetchone()

    # -- population helpers (tests / migration tooling) ------------------
    def add_tag_field(self, tag_field_id: int, name: str,
                      tag_field_type_id: int) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO tag_field VALUES (?, ?, ?)",
            (tag_field_id, name, tag_field_type_id))
        self._conn.commit()

    def add_tag_model(self, tag_model_id: int, name: str, ref_image_url: str,
                      fields=()) -> None:
        """fields: iterable of (tag_field_id, geometrical_info_json)."""
        self._conn.execute(
            "INSERT OR REPLACE INTO tag_model VALUES (?, ?, ?)",
            (tag_model_id, name, ref_image_url))
        for fid, geo in fields:
            self._conn.execute(
                "INSERT OR REPLACE INTO tag_model_field VALUES (?, ?, ?)",
                (tag_model_id, fid, geo))
        self._conn.commit()


def make_fiducial_geo(x: float, y: float, width: float, height: float,
                      image_size: tuple[int, int]) -> str:
    """geometricalInfo JSON for a normalized fiducial box (string-valued
    fields, the DB's storage convention)."""
    w_img, h_img = image_size
    return json.dumps({
        "X": str(x), "Y": str(y), "width": str(width), "height": str(height),
        "X_pixels": str(int(x * w_img)), "Y_pixels": str(int(y * h_img)),
        "width_pixels": str(int(width * w_img)),
        "height_pixels": str(int(height * h_img)),
        "w_image": str(w_img), "h_image": str(h_img),
    })


def _image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file (utils.cpp:30-39 getImageSize)."""
    from .utils.imageio import image_size

    return image_size(path)


def extract_tag_model_fiducials(db: TagDB) -> list[ModelTag]:
    """Replica of extractTagModelFiducialsFromDB (utils.cpp:66-111).

    For every tag model: load its reference-image size, keep fields of the
    fiducial type, parse their geometricalInfo into pixel crops, validate
    the crop against the image bounds (bad positions raise, like the
    reference's invalid_argument), and return models that have >= 1 crop.
    """
    model_tags: list[ModelTag] = []
    for mid, name, url, fields in db.get_all_tag_models():
        size = _image_size(url)
        tag = ModelTag(model_id=mid, model_file_name=url, image_size=size,
                       model_name=name)
        for tag_field_id, geo in fields:
            row = db.get_tag_field(tag_field_id)
            if row is None or row[2] != FIDUCIAL_FIELD_TYPE:
                continue
            box = parse_positions(geo, size)
            if (box.x >= 0 and box.y >= 0
                    and box.x + box.width <= size[0]
                    and box.y + box.height <= size[1]):
                tag.crops.append(
                    (tag_field_id, (box.x, box.y, box.width, box.height)))
            else:
                raise ValueError(
                    f"fiducial position of field '{row[1]}' in model "
                    f"'{name}' is out of the image bounds; fix the "
                    f"template database")
        if tag.crops:
            model_tags.append(tag)
    return model_tags


def fiducial_crop_path(model_file_name: str, tag_field_id: int) -> str:
    """Path where the fiducial crop image is stored next to the model image:
    ``<stem>.<tagFieldID><ext>`` (test_jabil.cpp:70-76)."""
    stem, ext = os.path.splitext(model_file_name)
    return f"{stem}.{tag_field_id}{ext}"
