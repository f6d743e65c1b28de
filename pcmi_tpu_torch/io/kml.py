"""KML AOI parsing (port of ``pcmi_tpu/io/kml.py``, stdlib only) —
replaces GDAL/OGR KML handling.

The reference opens the AOI KML with OGR and reads its extent
(``preprocessing.py:7-27``). KML is plain XML; the only geometry the
pipeline needs is the lon/lat extent of the first polygon(s), so this
parser is ~40 lines of stdlib ElementTree instead of a native dependency.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import List, Tuple

_COORD_RE = re.compile(r"[,\s]+")


def _parse_coordinates(text: str) -> List[Tuple[float, float]]:
    """Parse a KML <coordinates> blob: 'lon,lat[,alt] lon,lat[,alt] ...'."""
    pts = []
    for chunk in text.strip().split():
        parts = chunk.split(",")
        if len(parts) >= 2:
            pts.append((float(parts[0]), float(parts[1])))
    return pts


def parse_kml_polygons(path_or_text: str) -> List[List[Tuple[float, float]]]:
    """All polygon outer rings in a KML file or KML text."""
    text = path_or_text
    if not path_or_text.lstrip().startswith("<"):
        with open(path_or_text, "r", encoding="utf-8") as fh:
            text = fh.read()
    # strip the default namespace so tag matching is simple
    text = re.sub(r'xmlns="[^"]+"', "", text, count=1)
    root = ET.fromstring(text)
    polys = []
    for coords in root.iter("coordinates"):
        pts = _parse_coordinates(coords.text or "")
        if len(pts) >= 3:
            polys.append(pts)
    return polys


def kml_extent(path_or_text: str) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """((lon_min, lon_max), (lat_min, lat_max)) over all polygons —
    the reference's ``GetExtent`` usage (``preprocessing.py:18-27``)."""
    polys = parse_kml_polygons(path_or_text)
    if not polys:
        raise ValueError("KML contains no polygon coordinates")
    lons = [p[0] for poly in polys for p in poly]
    lats = [p[1] for poly in polys for p in poly]
    return (min(lons), max(lons)), (min(lats), max(lats))
