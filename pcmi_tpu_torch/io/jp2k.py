"""JPEG2000 codestream encode/decode for NITF IC=C8 image segments (port
of ``pcmi_tpu/io/jp2k.py``; optional, on Pillow's OpenJPEG codec).

Real WorldView-3 deliveries ship their PAN/MSI image segments as JPEG2000
codestreams inside NITF (IC=C8, NPJE profile); the reference decodes them
through GDAL (``members/rafael/disparity/preprocessing.py:71-80``
``gdal.Translate`` on the ``.ntf``). This framework keeps the NITF walker
in-repo (:mod:`pcmi_tpu_torch.io.nitf`) and delegates only the entropy-coded
codestream to the OpenJPEG codec via Pillow — no GDAL. Without Pillow,
:func:`available` is False and the C8 paths raise.

A raw J2K codestream starts with the SOC marker ``FF4F``; Pillow's
``Jpeg2KImagePlugin`` accepts it directly from a buffer. 16-bit lossless
(reversible 5/3 wavelet) round-trips bit-exactly, which covers WV3's
11-bit-in-16 PAN data.
"""

from __future__ import annotations

import io

import numpy as np

_SOC = b"\xff\x4f\xff\x51"  # SOC + SIZ marker: raw codestream
_JP2 = b"\x00\x00\x00\x0c\x6a\x50"  # JP2 signature box


def available() -> bool:
    """True when a JPEG2000 codec (Pillow + OpenJPEG) is importable."""
    try:
        from PIL import features

        return bool(features.check("jpg_2000"))
    except Exception:
        return False


def _require_codec():
    if not available():
        raise RuntimeError(
            "JPEG2000 (IC=C8) segment needs the OpenJPEG codec "
            "(Pillow with jpg_2000 support) — not available in this "
            "environment; re-deliver the NITF uncompressed (IC=NC) or "
            "install Pillow/openjpeg"
        )


def is_j2k(data: bytes) -> bool:
    """Sniff a JPEG2000 payload (raw codestream or JP2 container)."""
    return data[:4] == _SOC or data[:6] == _JP2


def decode(data: bytes) -> np.ndarray:
    """Decode a JPEG2000 payload to ``(h, w)`` or ``(h, w, bands)``.

    Accepts both raw codestreams (NITF C8 stores these) and JP2
    containers. Output dtype follows the codestream precision
    (uint8 / uint16 / int32 for >16-bit).
    """
    _require_codec()
    from PIL import Image

    buf = io.BytesIO(data)
    with Image.open(buf) as im:
        im.load()
        arr = np.asarray(im)
    return arr


def encode(img: np.ndarray, lossless: bool = True,
           ratio: float = 10.0, tile_size: tuple | None = None) -> bytes:
    """Encode an array as a raw J2K codestream (what NITF C8 embeds).

    ``lossless`` uses the reversible 5/3 wavelet (bit-exact round-trip);
    otherwise the irreversible 9/7 wavelet at roughly ``ratio``:1.
    Supports uint8 and uint16 (mono) plus uint8 RGB.

    ``tile_size=(w, h)`` produces an internally TILED codestream — the
    NPJE blocked convention real WV3 deliveries use (1024x1024 J2K tiles
    inside one IC=C8 segment with matching NPPBH/NPPBV block fields).
    """
    _require_codec()
    from PIL import Image

    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(
            f"JPEG2000 encode supports uint8/uint16, got {img.dtype}"
        )
    if img.ndim == 3 and img.dtype != np.uint8:
        raise ValueError("multi-band JPEG2000 encode supports uint8 only")
    im = Image.fromarray(img)
    buf = io.BytesIO()
    buf.name = "segment.j2k"  # suffix selects the raw-codestream writer
    kwargs = dict(format="JPEG2000", irreversible=not lossless)
    if tile_size is not None:
        kwargs["tile_size"] = (int(tile_size[0]), int(tile_size[1]))
    if not lossless:
        kwargs["quality_mode"] = "rates"
        kwargs["quality_layers"] = [float(ratio)]
    im.save(buf, **kwargs)
    data = buf.getvalue()
    assert data[:2] == b"\xff\x4f", "expected raw codestream output"
    return data
