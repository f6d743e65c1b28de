"""NITF metadata + RPC00B parsing (port of ``pcmi_tpu/io/nitf.py``: the
same bytes written and read, bound to the port's :class:`RPCCamera`) —
replaces rasterio/GDAL tag access.

The reference reads WV3 ``.NTF`` metadata through rasterio's GDAL bindings
(``nitf_utils.py:17-37``): incidence angle (``NITF_USE00A_OBL_ANG``),
azimuth of obliquity (``NITF_CSEXRA_AZ_OF_OBLIQUITY``), acquisition datetime
(``NITF_IDATIM``) and the RPC00B camera. This module parses the same
information without native code:

* :func:`parse_rpc_sidecar` — GDAL ``_RPC.TXT`` / WorldView ``.RPB`` sidecars
  (plain-text key/value formats).
* :func:`parse_nitf_tres` — scans a raw NITF 2.x file for the fixed-width
  ASCII TREs the pipeline needs (``RPC00B``, ``USE00A``, ``CSEXRA``) plus
  ``IDATIM`` from the file header. TREs are self-describing fixed-layout
  ASCII, so a targeted scan is robust without a full NITF segment walker.
* :class:`NITFMetadata` — the reference's metadata record + view vector.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from pcmi_tpu_torch.geometry.pairs import view_vector_np
from pcmi_tpu_torch.geometry.rpc import RPCCamera


# ---------------------------------------------------------------------------
# sidecar text formats
# ---------------------------------------------------------------------------

_RPB_KEYMAP = {
    "lineoffset": "LINE_OFF", "sampoffset": "SAMP_OFF",
    "latoffset": "LAT_OFF", "longoffset": "LONG_OFF",
    "heightoffset": "HEIGHT_OFF", "linescale": "LINE_SCALE",
    "sampscale": "SAMP_SCALE", "latscale": "LAT_SCALE",
    "longscale": "LONG_SCALE", "heightscale": "HEIGHT_SCALE",
    "linenumcoef": "LINE_NUM_COEFF", "linedencoef": "LINE_DEN_COEFF",
    "sampnumcoef": "SAMP_NUM_COEFF", "sampdencoef": "SAMP_DEN_COEFF",
}


def parse_rpc_sidecar(text: str) -> Dict[str, object]:
    """Parse GDAL ``_RPC.TXT`` or WorldView ``.RPB`` content into the
    GDAL-style tag dict that :meth:`RPCCamera.from_dict` accepts."""
    if "=" in text and ";" in text:  # .RPB (licence block + key = value;)
        out: Dict[str, object] = {}
        # vector groups: key = ( v1, v2, ... );
        for m in re.finditer(r"(\w+)\s*=\s*\(([^)]*)\)\s*;", text, re.S):
            key = _RPB_KEYMAP.get(m.group(1).lower())
            if key:
                out[key] = [float(v) for v in re.split(r"[,\s]+", m.group(2).strip()) if v]
        for m in re.finditer(r"(\w+)\s*=\s*([-+0-9.eE]+)\s*;", text):
            key = _RPB_KEYMAP.get(m.group(1).lower())
            if key:
                out[key] = float(m.group(2))
        return out
    # _RPC.TXT: "LINE_OFF: +0123.00 pixels" / "LINE_NUM_COEFF_1: ..."
    out = {}
    coeffs: Dict[str, list] = {}
    for line in text.splitlines():
        if ":" not in line:
            continue
        key, val = line.split(":", 1)
        key = key.strip().upper()
        num = re.search(r"[-+0-9.eE]+", val)
        if not num:
            continue
        v = float(num.group(0))
        m = re.match(r"(LINE|SAMP)_(NUM|DEN)_COEFF_(\d+)", key)
        if m:
            base = f"{m.group(1)}_{m.group(2)}_COEFF"
            coeffs.setdefault(base, [0.0] * 20)[int(m.group(3)) - 1] = v
        else:
            out[key] = v
    out.update(coeffs)
    return out


# ---------------------------------------------------------------------------
# raw NITF TRE scan
# ---------------------------------------------------------------------------

def _parse_rpc00b(payload: bytes) -> Dict[str, object]:
    """Decode the fixed-width ASCII RPC00B TRE body (after the 6-byte tag +
    5-byte length). Layout per STDI-0002: SUCCESS(1) ERR_BIAS(7) ERR_RAND(7)
    LINE_OFF(6) SAMP_OFF(5) LAT_OFF(8) LONG_OFF(9) HEIGHT_OFF(5)
    LINE_SCALE(6) SAMP_SCALE(5) LAT_SCALE(8) LONG_SCALE(9) HEIGHT_SCALE(5)
    then 4x20 coefficients, 12 bytes each (±n.nnnnnnE±n)."""
    s = payload.decode("ascii", errors="replace")
    pos = 0

    def take(n):
        nonlocal pos
        v = s[pos:pos + n]
        pos += n
        return v

    take(1)  # SUCCESS
    take(7); take(7)  # ERR_BIAS, ERR_RAND
    fields = {}
    for key, width in [
        ("LINE_OFF", 6), ("SAMP_OFF", 5), ("LAT_OFF", 8), ("LONG_OFF", 9),
        ("HEIGHT_OFF", 5), ("LINE_SCALE", 6), ("SAMP_SCALE", 5),
        ("LAT_SCALE", 8), ("LONG_SCALE", 9), ("HEIGHT_SCALE", 5),
    ]:
        fields[key] = float(take(width))
    for key in ["LINE_NUM_COEFF", "LINE_DEN_COEFF",
                "SAMP_NUM_COEFF", "SAMP_DEN_COEFF"]:
        fields[key] = [float(take(12)) for _ in range(20)]
    return fields


def _find_tre(data: bytes, tag: bytes) -> Optional[bytes]:
    """Locate a TRE by tag; returns its payload (length from the 5-byte
    ASCII CEL field that follows the tag)."""
    idx = data.find(tag)
    while idx != -1:
        try:
            length = int(data[idx + 6: idx + 11])
            return data[idx + 11: idx + 11 + length]
        except ValueError:
            idx = data.find(tag, idx + 1)
    return None


def parse_nitf_tres(path: str, scan_bytes: int = 1 << 20) -> Dict[str, object]:
    """Scan the head of a NITF file for IDATIM / USE00A / CSEXRA / RPC00B."""
    with open(path, "rb") as fh:
        head = fh.read(scan_bytes)
    out: Dict[str, object] = {}
    if head[:4] != b"NITF":
        raise ValueError(f"{path}: not a NITF file")
    # IDATIM: 14-char CCYYMMDDhhmmss at fixed offset in the file header
    # (NITF02.10: FHDR(9) CLEVEL(2) STYPE(4) OSTAID(10) FDT(14) -> offset 25
    # is the *file* date; the image acquisition IDATIM lives in the image
    # subheader, so scan for a plausible datetime after an 'IM' marker too.)
    fdt = head[25:39].decode("ascii", errors="replace")
    if fdt.isdigit():
        out["IDATIM"] = fdt
    rpc = _find_tre(head, b"RPC00B")
    if rpc:
        out["RPC"] = _parse_rpc00b(rpc)
    use = _find_tre(head, b"USE00A")
    if use:
        # USE00A (STDI-0002): ANGLE_TO_NORTH(3) MEAN_GSD(5) rsrvd(1)
        # DYNAMIC_RANGE(5) rsrvd(3) rsrvd(1) rsrvd(3) -> OBL_ANG at [21:26],
        # ROLL_ANG at [26:32]
        s = use.decode("ascii", errors="replace")
        try:
            out["OBL_ANG"] = float(s[21:26])
        except ValueError:
            pass
    cse = _find_tre(head, b"CSEXRA")
    if cse:
        s = cse.decode("ascii", errors="replace")
        # CSEXRA (STDI-0002): SENSOR(6) TIME_FIRST_LINE_IMAGE(12)
        # TIME_IMAGE_DURATION(12) MAX_GSD(5) ALONG_SCAN_GSD(5)
        # CROSS_SCAN_GSD(5) GEO_MEAN_GSD(5) A_S_VERT_GSD(5) C_S_VERT_GSD(5)
        # GEO_MEAN_VERT_GSD(5) GSD_BETA_ANGLE(5) DYNAMIC_RANGE(2)
        # NUM_LINES(7) NUM_SAMPLES(5) ANGLE_TO_NORTH(7) ->
        # OBLIQUITY_ANGLE at [91:97], AZ_OF_OBLIQUITY at [97:104]
        try:
            out["OBLIQUITY_ANGLE"] = float(s[91:97])
            out["AZ_OF_OBLIQUITY"] = float(s[97:104])
        except ValueError:
            pass
    return out


# ---------------------------------------------------------------------------
# NITF 2.1 image segment decode (uncompressed) + test-grade writer
# ---------------------------------------------------------------------------

def nitf_image_info(path: str, segment: int = 0) -> Dict[str, object]:
    """Header-only probe of one image segment: shape/dtype/offset.

    Reads just the file header + that segment's subheader (no pixel
    data) — the cheap path for directory discovery over multi-gigabyte
    deliveries. Real WV3 deliveries carry several image segments per
    file (PAN + multi-band MSI); ``segment`` indexes the NUMI list.
    """
    with open(path, "rb") as fh:
        head = fh.read(1 << 16)
        if head[:9] != b"NITF02.10" and head[:4] != b"NITF":
            raise ValueError(f"{path}: not a NITF file")
        hl = int(head[354:360])
        numi = int(head[360:363])
        if numi < 1:
            raise ValueError("no image segments")
        if not 0 <= segment < numi:
            raise ValueError(f"{path}: segment {segment} of {numi}")
        # LISH(6)/LI(10) pairs repeat per segment right after NUMI
        pairs = [
            (int(head[363 + 16 * i: 369 + 16 * i]),
             int(head[369 + 16 * i: 379 + 16 * i]))
            for i in range(numi)
        ]
        seg_off = hl + sum(s + l for s, l in pairs[:segment])
        lish, li = pairs[segment]
        fh.seek(seg_off)
        sub = fh.read(lish)

    pos = 2 + 10 + 14 + 17 + 80 + 1  # IM IID1 IDATIM TGTID IID2 ISCLAS
    pos += 166                        # security group
    pos += 1 + 42                     # ENCRYP ISORCE
    nrows = int(sub[pos:pos + 8]); pos += 8
    ncols = int(sub[pos:pos + 8]); pos += 8
    pvtype = sub[pos:pos + 3].decode(); pos += 3
    pos += 8 + 8                      # IREP ICAT
    pos += 2 + 1                      # ABPP PJUST
    icords = sub[pos:pos + 1].decode(); pos += 1
    if icords.strip():
        pos += 60                     # IGEOLO
    nicom = int(sub[pos:pos + 1]); pos += 1 + 80 * nicom
    ic = sub[pos:pos + 2].decode(); pos += 2
    comrat = ""
    if ic not in ("NC", "NM"):
        # COMRAT(4) is present whenever the segment is compressed
        comrat = sub[pos:pos + 4].decode(); pos += 4
    if ic not in ("NC", "NM", "C8", "M8"):
        raise ValueError(f"{path}: compression {ic} unsupported "
                         f"(IC=NC/NM raw or IC=C8/M8 JPEG2000 only)")
    nbands = int(sub[pos:pos + 1]); pos += 1
    # per band: IREPBANDn(2) ISUBCATn(6) IFCn(1) IMFLTn(3) NLUTSn(1)
    pos += nbands * (2 + 6 + 1 + 3 + 1)
    pos += 1                               # ISYNC
    imode = sub[pos:pos + 1].decode(); pos += 1
    nbpr = int(sub[pos:pos + 4]); pos += 4
    nbpc = int(sub[pos:pos + 4]); pos += 4
    nppbh = int(sub[pos:pos + 4]); pos += 4
    nppbv = int(sub[pos:pos + 4]); pos += 4
    nbpp = int(sub[pos:pos + 2]); pos += 2

    dt = {("INT", 8): np.uint8, ("INT", 16): ">u2", ("INT", 32): ">u4",
          ("SI", 16): ">i2", ("R", 32): ">f4"}.get((pvtype.strip(), nbpp))
    if dt is None:
        raise ValueError(f"unsupported PVTYPE/NBPP {pvtype}/{nbpp}")
    return {
        "nrows": nrows, "ncols": ncols, "nbands": nbands,
        "dtype": np.dtype(dt), "data_offset": seg_off + lish,
        "ic": ic, "comrat": comrat, "data_length": li,
        "n_segments": numi, "imode": imode,
        "nbpr": nbpr, "nbpc": nbpc, "nppbh": nppbh, "nppbv": nppbv,
    }


def read_nitf_segments(path: str) -> list:
    """Decode every image segment of a NITF 2.1 file (multi-segment WV3
    deliveries: PAN + MSI bands in one .ntf)."""
    n = int(nitf_image_info(path)["n_segments"])
    return [read_nitf_image(path, segment=k) for k in range(n)]


def read_nitf_image(path: str, segment: int = 0) -> np.ndarray:
    """Decode one image segment of a NITF 2.1 file (IC=NC/NM/C8).

    Walks the fixed-layout file header (MIL-STD-2500C: FL at offset 342,
    HL at 354, NUMI at 360 with LISH/LI pairs) to the requested image
    subheader, parses NROWS/NCOLS/PVTYPE/NBPP/IC, and reads the band.
    Raw segments (IC=NC/NM) come straight off disk; JPEG2000 segments
    (IC=C8 — how real WV3 deliveries arrive; the reference decoded them
    via GDAL, ``preprocessing.py:71-80``) go through
    :mod:`pcmi_tpu_torch.io.jp2k`, including NPJE-style blocked segments whose
    J2K codestream is internally tiled (IMODE=B, NPPBH/NPPBV blocks —
    tiling is a property of the codestream, so the codec reassembles it).
    """
    info = nitf_image_info(path, segment=segment)
    nrows, ncols, nbands = info["nrows"], info["ncols"], info["nbands"]
    dt: np.dtype = info["dtype"]  # type: ignore[assignment]
    if info["ic"] in ("C8", "M8"):
        from pcmi_tpu_torch.io import jp2k

        with open(path, "rb") as fh:
            fh.seek(int(info["data_offset"]))
            data = fh.read(int(info["data_length"]))
        if info["ic"] == "M8":
            # Blocked Image Mask: per-block offsets, one complete
            # codestream per (padded) block — split, decode, assemble,
            # crop the edge-block padding.
            import struct

            imdatoff, bmrlnth, _tmr, _tpx = struct.unpack(">IHHH", data[:10])
            if bmrlnth != 4:
                raise ValueError(f"{path}: unsupported M8 mask BMRLNTH={bmrlnth}")
            nbpr, nbpc = int(info["nbpr"]), int(info["nbpc"])
            nb = nbpr * nbpc
            offs = struct.unpack(f">{nb}I", data[10:10 + 4 * nb])
            body = data[imdatoff:]
            bounds = list(offs) + [len(body)]
            th, tw = int(info["nppbv"]), int(info["nppbh"])
            out = None
            k = 0
            for by in range(nbpc):
                for bx in range(nbpr):
                    blk = jp2k.decode(body[bounds[k]:bounds[k + 1]])
                    if out is None:
                        out = np.zeros((nbpc * th, nbpr * tw), blk.dtype)
                    out[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] = blk
                    k += 1
            return out[:nrows, :ncols]
        arr = jp2k.decode(data)
        if arr.shape[:2] != (nrows, ncols):
            raise ValueError(
                f"{path}: J2K codestream {arr.shape[:2]} does not match "
                f"subheader NROWS/NCOLS ({nrows}, {ncols})"
            )
        return arr
    if int(info["nbpr"]) > 1 or int(info["nbpc"]) > 1:
        raise ValueError(
            f"{path}: blocked RAW layout (NBPR={info['nbpr']}, "
            f"NBPC={info['nbpc']}, IC={info['ic']}) is not supported — "
            f"blocked deliveries arrive as C8 (J2K-tiled) in practice"
        )
    with open(path, "rb") as fh:
        fh.seek(int(info["data_offset"]))
        data = fh.read(nrows * ncols * nbands * dt.itemsize)
    arr = np.frombuffer(data, dt, count=nrows * ncols * nbands)
    arr = arr.astype(dt.newbyteorder("="))
    if nbands > 1:
        return arr.reshape(nrows, ncols, nbands)
    return arr.reshape(nrows, ncols)


def rpc00b_tre(rpc, err_bias: float = 0.0) -> bytes:
    """Serialise an :class:`RPCCamera` as an RPC00B TRE (tag+length+body) —
    the inverse of :func:`_parse_rpc00b`, used by the NITF writer so disk
    roundtrips carry full camera geometry."""
    def f12(v):
        s = f"{v:+.6E}"            # +d.ddddddE+dd
        mant, ex = s.split("E")
        return f"{mant}E{int(ex):+d}".ljust(12)[:12]

    body = "1" + f"{err_bias:07.2f}" + f"{0.0:07.2f}"
    body += f"{int(round(float(rpc.line_off))):06d}"
    body += f"{int(round(float(rpc.samp_off))):05d}"
    body += f"{float(rpc.lat_off):+08.4f}"
    body += f"{float(rpc.long_off):+09.4f}"
    body += f"{int(round(float(rpc.height_off))):+05d}"
    body += f"{int(round(float(rpc.line_scale))):06d}"
    body += f"{int(round(float(rpc.samp_scale))):05d}"
    body += f"{float(rpc.lat_scale):+08.4f}"
    body += f"{float(rpc.long_scale):+09.4f}"
    body += f"{int(round(float(rpc.height_scale))):+05d}"
    for coeffs in [rpc.line_num, rpc.line_den, rpc.samp_num, rpc.samp_den]:
        for v in np.asarray(coeffs, np.float64):
            body += f12(v)
    payload = body.encode("ascii")
    return b"RPC00B" + f"{len(payload):05d}".encode() + payload


def use00a_tre(incidence_deg: float) -> bytes:
    # OBL_ANG sits at body offset 21 (see parse_nitf_tres layout comment)
    body = (" " * 21 + f"{incidence_deg:05.2f}").ljust(107).encode("ascii")
    return b"USE00A" + f"{len(body):05d}".encode() + body


def csexra_tre(incidence_deg: float, azimuth_deg: float) -> bytes:
    # OBLIQUITY_ANGLE at offset 91 (6), AZ_OF_OBLIQUITY at 97 (7)
    body = (" " * 91 + f"{incidence_deg:06.2f}" + f"{azimuth_deg:07.2f}"
            ).ljust(132).encode("ascii")
    return b"CSEXRA" + f"{len(body):05d}".encode() + body


def write_nitf(path: str, img, tres: bytes = b"",
               idatim: str = "20200101120000", compress: str = "NC",
               tile_size: int = 0) -> None:
    """Minimal NITF 2.1 writer (mono image segments, IC=NC or C8).

    Exists so tests and demos can exercise the full NTF ingest path
    (header walk + TRE scan + image decode) without shipped samples.
    ``tres`` are raw TRE bytes placed in the FIRST segment's extended
    data area. ``compress="C8"`` embeds a lossless JPEG2000 codestream —
    the form real WV3 deliveries take — so the C8 decode path is
    testable. ``tile_size > 0`` writes the NPJE blocked convention: an
    internally J2K-tiled codestream with IMODE=B and matching
    NPPBH/NPPBV/NBPR/NBPC block fields. ``img`` may be a LIST of arrays —
    one image segment each (multi-segment deliveries: PAN + MSI)."""
    imgs = list(img) if isinstance(img, (list, tuple)) else [np.asarray(img)]
    if compress not in ("NC", "C8", "M8"):
        raise ValueError(f"compress must be NC, C8 or M8, got {compress!r}")
    if tile_size and compress == "NC":
        raise ValueError("tile_size (blocking) requires compress='C8'/'M8'")
    segs = [
        _image_segment(np.asarray(im), tres if k == 0 else b"", idatim,
                       compress, tile_size)
        for k, im in enumerate(imgs)
    ]
    numi = len(segs)

    sec = b" " * 166
    # Build the file header strictly by field widths:
    # FHDR(9) CLEVEL(2) STYPE(4) OSTAID(10) FDT(14) FTITLE(80) FSCLAS(1)
    # FS-security(166) FSCOP(5) FSCPYS(5) ENCRYP(1) FBKGC(3) ONAME(24)
    # OPHONE(18) FL(12) HL(6) NUMI(3) [LISH(6) LI(10)]*NUMI NUMS(3)
    # NUMX(3) NUMT(3) NUMDES(3) NUMRES(3) UDHDL(5) XHDL(5)
    parts = [
        b"NITF02.10", b"03", b"BF01", b"PCMI      ",
        idatim.encode().ljust(14), b" " * 80, b"U", sec,
        b"00000", b"00000", b"0", b"\x00\x00\x00", b" " * 24, b" " * 18,
    ]
    tail = [b"".join(f"{len(sub):06d}".encode() + f"{len(raw):010d}".encode()
                     for sub, raw in segs),
            b"000", b"000", b"000", b"000", b"000", b"00000", b"00000"]
    hl = sum(len(p) for p in parts) + 12 + 6 + 3 + sum(len(t) for t in tail)
    fl = hl + sum(len(sub) + len(raw) for sub, raw in segs)
    header = b"".join(parts) + f"{fl:012d}".encode() + f"{hl:06d}".encode() \
        + f"{numi:03d}".encode() + b"".join(tail)
    assert len(header) == hl, (len(header), hl)
    with open(path, "wb") as fh:
        fh.write(header)
        for sub, raw in segs:
            fh.write(sub + raw)


def _image_segment(img: np.ndarray, tres: bytes, idatim: str,
                   compress: str, tile_size: int = 0):
    """(subheader bytes, data bytes) for one mono image segment."""
    if img.dtype == np.uint8:
        pvtype, nbpp, raw = "INT", 8, img.tobytes()
    elif img.dtype in (np.uint16, np.dtype(">u2")):
        pvtype, nbpp = "INT", 16
        raw = img.astype(">u2").tobytes()
    elif img.dtype in (np.float32, np.dtype(">f4")):
        pvtype, nbpp = "R", 32
        raw = img.astype(">f4").tobytes()
    else:
        raise ValueError(f"unsupported dtype {img.dtype}")
    nrows, ncols = img.shape[:2]
    if tile_size:
        nbpr = -(-ncols // tile_size)
        nbpc = -(-nrows // tile_size)
        nppbh = nppbv = tile_size
    else:
        nbpr = nbpc = 1
        nppbh, nppbv = min(ncols, 9999), min(nrows, 9999)
    imode = b"B"
    if compress in ("C8", "M8"):
        if pvtype != "INT":
            raise ValueError("C8/M8 (JPEG2000) supports integer imagery only")
        from pcmi_tpu_torch.io import jp2k

        native = img.astype(img.dtype.newbyteorder("="))
        if compress == "M8" and tile_size:
            # Blocked-with-mask form (MIL-STD-2500C): each NPPBxNPPB block
            # (edge blocks zero-padded to full size, as the spec requires)
            # is its OWN complete codestream; a Blocked Image Mask up
            # front records the per-block offsets, so readers can split
            # without guessing marker boundaries.
            blocks = []
            for by in range(nbpc):
                for bx in range(nbpr):
                    blk = np.zeros((tile_size, tile_size), native.dtype)
                    part = native[by * tile_size: (by + 1) * tile_size,
                                  bx * tile_size: (bx + 1) * tile_size]
                    blk[: part.shape[0], : part.shape[1]] = part
                    blocks.append(jp2k.encode(blk))
            import struct

            offs, pos = [], 0
            for b in blocks:
                offs.append(pos)
                pos += len(b)
            # IMDATOFF(4) BMRLNTH(2) TMRLNTH(2) TPXCDLNTH(2) + offsets
            mask = struct.pack(">IHHH", 4 + 2 + 2 + 2 + 4 * len(offs),
                               4, 0, 0)
            mask += b"".join(struct.pack(">I", o) for o in offs)
            raw = mask + b"".join(blocks)
        elif compress == "M8":
            raise ValueError("M8 (masked blocks) requires tile_size > 0")
        elif tile_size:
            # single internally-tiled codestream (the NPJE C8 convention).
            # The available encoder (Pillow/OpenJPEG) mis-encodes TILED
            # uint16 (verified: tiled uint8 round-trips bit-exactly,
            # tiled uint16 does not) — blocked 16-bit fixtures should use
            # compress="M8" instead; real NPJE C8 arrives pre-encoded and
            # only needs the DECODE path.
            if native.dtype != np.uint8:
                raise ValueError(
                    "tiled C8 encode supports uint8 only (encoder "
                    "limitation) — use compress='M8' for blocked 16-bit"
                )
            raw = jp2k.encode(native, tile_size=(tile_size, tile_size))
        else:
            raw = jp2k.encode(native)

    sec = b" " * 166
    udidl = len(tres)
    # image subheader, strictly by field widths (MIL-STD-2500C):
    # IM(2) IID1(10) IDATIM(14) TGTID(17) IID2(80) ISCLAS(1) security(166)
    # ENCRYP(1) ISORCE(42) NROWS(8) NCOLS(8) PVTYPE(3) IREP(8) ICAT(8)
    # ABPP(2) PJUST(1) ICORDS(1) NICOM(1) IC(2) NBANDS(1)
    # band1: IREPBAND(2) ISUBCAT(6) IFC(1) IMFLT(3) NLUTS(1)
    # ISYNC(1) IMODE(1) NBPR(4) NBPC(4) NPPBH(4) NPPBV(4) NBPP(2)
    # IDLVL(3) IALVL(3) ILOC(10) IMAG(4) UDIDL(5) [UDOFL(3) UDID] IXSHDL(5)
    sub = b"".join([
        b"IM", b"PCMI      ", idatim.encode().ljust(14), b" " * 17,
        b" " * 80, b"U", sec, b"0", b" " * 42,
        f"{nrows:08d}".encode(), f"{ncols:08d}".encode(),
        pvtype.ljust(3).encode(), b"MONO    ", b"VIS     ",
        f"{nbpp:02d}".encode(), b"R", b" ",
        b"0", compress.encode(),
        # COMRAT(4) follows IC only for compressed segments; "N023" is the
        # NPJE numerically-lossless convention.
        b"N023" if compress in ("C8", "M8") else b"",
        b"1",
        b"M ", b"      ", b"N", b"   ", b"0",
        b"1", imode,
        f"{nbpr:04d}".encode(), f"{nbpc:04d}".encode(),
        f"{nppbh:04d}".encode(), f"{nppbv:04d}".encode(),
        f"{nbpp:02d}".encode(),
        b"001", b"000", b"0000000000", b"1.0 ",
    ])
    if udidl:
        sub += f"{udidl + 3:05d}".encode() + b"000" + tres
    else:
        sub += b"00000"
    sub += b"00000"  # IXSHDL
    return sub, raw


@dataclass
class NITFMetadata:
    """Parity with reference ``NITFMetadata`` (``nitf_utils.py:10-81``)."""

    incidence_deg: float
    azimuth_deg: float
    datetime_str: str = ""
    rpc: Optional[RPCCamera] = None
    path: str = ""

    @classmethod
    def from_tags(cls, tags: Dict[str, object], path: str = "") -> "NITFMetadata":
        """From GDAL-style NITF_* tag names or our TRE-scan output."""
        def get(*keys, default=0.0):
            for k in keys:
                if k in tags:
                    return tags[k]
            return default

        inc = float(get("NITF_USE00A_OBL_ANG", "OBL_ANG", "OBLIQUITY_ANGLE"))
        az = float(get("NITF_CSEXRA_AZ_OF_OBLIQUITY", "AZ_OF_OBLIQUITY"))
        dt = str(get("NITF_IDATIM", "IDATIM", default=""))
        rpc = None
        if "RPC" in tags:
            rpc = RPCCamera.from_dict(tags["RPC"])  # type: ignore[arg-type]
        return cls(incidence_deg=inc, azimuth_deg=az, datetime_str=dt,
                   rpc=rpc, path=path)

    @classmethod
    def from_file(cls, path: str) -> "NITFMetadata":
        return cls.from_tags(parse_nitf_tres(path), path=path)

    @property
    def date_days(self) -> float:
        """Days since epoch 2000-01-01 parsed from CCYYMMDDhhmmss."""
        s = self.datetime_str
        if len(s) < 8 or not s[:8].isdigit():
            return 0.0
        import datetime as _dt

        d = _dt.datetime(int(s[0:4]), int(s[4:6]), int(s[6:8]))
        return (d - _dt.datetime(2000, 1, 1)).days + (
            int(s[8:10]) / 24.0 if len(s) >= 10 and s[8:10].isdigit() else 0.0
        )

    def get_view_vector(self) -> np.ndarray:
        """ENU unit vector to the satellite (ref ``nitf_utils.py:39-81``)."""
        return view_vector_np(self.incidence_deg, self.azimuth_deg)
