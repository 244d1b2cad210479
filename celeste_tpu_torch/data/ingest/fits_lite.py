"""Minimal FITS reader/writer (SURVEY.md C1: the reference leans on
astropy/fitsio, which this image lacks — this module implements the subset
SDSS frame/psField files need: primary + IMAGE extensions of any BITPIX,
and BINTABLE extensions with numeric/array columns).

FITS structure: a sequence of HDUs, each = header (80-char cards in
2880-byte blocks, terminated by END) + optional data payload (big-endian,
padded to 2880).  Binary tables: NAXIS1 bytes/row x NAXIS2 rows, column
layout from TFORMn codes (rAAA repeat-count + type letter).

Tested two ways: round-trip against the writer half (tests/test_ingest.py)
AND against hand-assembled golden byte streams built directly from the
FITS standard by an independent generator (tests/fixtures/ — so the reader
is not merely self-consistent).  BSCALE/BZERO and TSCALn/TZEROn scaling is
applied, including the exact unsigned-integer BZERO conventions (uint16 et
al.).  Variable-length arrays remain unsupported (documented limitation;
SDSS frames use none).
"""

from __future__ import annotations

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"), 16: np.dtype(">i2"), 32: np.dtype(">i4"),
    64: np.dtype(">i8"), -32: np.dtype(">f4"), -64: np.dtype(">f8"),
}
_TFORM_DTYPE = {
    "L": np.dtype(">u1"), "B": np.dtype(">u1"), "I": np.dtype(">i2"),
    "J": np.dtype(">i4"), "K": np.dtype(">i8"), "E": np.dtype(">f4"),
    "D": np.dtype(">f8"), "A": np.dtype("S1"),
}


def _parse_header(buf: bytes, off: int):
    """Parse one header; returns (dict, new_offset).  Values are coerced to
    int/float/bool/str."""
    cards = {}
    while True:
        block = buf[off:off + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        off += BLOCK
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY") or card[8] != "=":
                continue
            raw = card[10:]
            if "/" in raw and not raw.lstrip().startswith("'"):
                raw = raw.split("/")[0]
            raw = raw.strip()
            if raw.startswith("'"):
                val = raw[1:raw.rindex("'")].strip()
            elif raw in ("T", "F"):
                val = raw == "T"
            else:
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
            cards[key] = val
        if done:
            return cards, off


def _data_size(h):
    """Standard FITS data size: |BITPIX|/8 * GCOUNT * (PCOUNT + prod NAXIS_i)."""
    naxis = h.get("NAXIS", 0)
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= h[f"NAXIS{i}"]
    return abs(h["BITPIX"]) // 8 * h.get("GCOUNT", 1) * (h.get("PCOUNT", 0) + n)


def _parse_tform(tform: str):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code


# the FITS standard's unsigned-integer convention: (BITPIX, BZERO) pairs
# that mean "reinterpret the stored signed ints as this unsigned dtype"
_UNSIGNED_CONVENTION = {
    (8, -128): np.int8,            # signed bytes stored in unsigned BITPIX 8
    (16, 32768): np.uint16,
    (32, 2147483648): np.uint32,
    (64, 9223372036854775808): np.uint64,
}


def _apply_scaling(arr, bscale, bzero, bitpix=None):
    """physical = stored * BSCALE + BZERO, exactly.

    Integer-convention offsets (e.g. BITPIX 16 / BZERO 32768 = uint16) are
    applied losslessly by dtype reinterpretation — naive ``arr + 32768`` on
    an int16 array overflows under NumPy 2 scalar promotion.  Everything
    else goes through float64.
    """
    if bscale == 1 and bzero == 0:
        return arr
    if bscale == 1 and bitpix is not None:
        udt = _UNSIGNED_CONVENTION.get((bitpix, bzero))
        if udt is not None:
            if bitpix == 64:
                # int64 + 2^63 overflows int64 math; the offset is exactly a
                # sign-bit flip, so reinterpret bitwise
                return (arr.view(np.uint64) ^ np.uint64(1 << 63)).astype(udt)
            return (arr.astype(np.int64) + int(bzero)).astype(udt)
    return arr.astype(np.float64) * bscale + bzero


def _read_image(h, payload):
    dt = _BITPIX_DTYPE[h["BITPIX"]]
    shape = tuple(h[f"NAXIS{i}"] for i in range(h.get("NAXIS", 0), 0, -1))
    arr = np.frombuffer(payload, dtype=dt, count=int(np.prod(shape))).reshape(shape)
    arr = arr.astype(dt.newbyteorder("="))
    return _apply_scaling(arr, h.get("BSCALE", 1), h.get("BZERO", 0),
                          bitpix=h["BITPIX"])


def _parse_tdim(tdim: str):
    """'(8,6)' -> (6, 8) numpy-order shape (FITS lists fastest axis first)."""
    dims = [int(x) for x in tdim.strip().strip("()").split(",") if x.strip()]
    return tuple(reversed(dims))


def _read_bintable(h, payload):
    nrow, rowbytes, nfield = h["NAXIS2"], h["NAXIS1"], h["TFIELDS"]
    cols = {}
    offset = 0
    raw = np.frombuffer(payload, dtype=np.uint8,
                        count=nrow * rowbytes).reshape(nrow, rowbytes)
    for f in range(1, nfield + 1):
        repeat, code = _parse_tform(str(h[f"TFORM{f}"]))
        name = str(h.get(f"TTYPE{f}", f"col{f}")).strip()
        dt = _TFORM_DTYPE[code]
        nbytes = repeat * dt.itemsize
        colraw = raw[:, offset:offset + nbytes].copy()
        if code == "A":
            cols[name] = np.array([bytes(r).decode("ascii").rstrip() for r in colraw])
        else:
            arr = colraw.view(dt).reshape(nrow, repeat)
            arr = arr.astype(dt.newbyteorder("="))
            tscal, tzero = h.get(f"TSCAL{f}", 1), h.get(f"TZERO{f}", 0)
            if tscal != 1 or tzero != 0:
                bitpix = {"B": 8, "I": 16, "J": 32, "K": 64}.get(code)
                arr = _apply_scaling(arr, tscal, tzero, bitpix=bitpix)
            tdim = h.get(f"TDIM{f}")
            if tdim is not None:
                # rank-consistent contract: TDIM columns are ALWAYS
                # [nrow, *cell_shape] (no nrow==1 squeeze — consumers could
                # not distinguish one [a,b] cell from an [a,b] column)
                cols[name] = arr.reshape((nrow,) + _parse_tdim(str(tdim)))
            else:
                cols[name] = arr[:, 0] if repeat == 1 else arr
        offset += nbytes
    return cols


def read_fits(path_or_bytes):
    """Parse a FITS file -> list of HDUs: dicts with 'header' and 'data'
    (ndarray for images, dict-of-columns for bintables, None otherwise)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            buf = fh.read()
    hdus = []
    off = 0
    while off < len(buf):
        if not buf[off:off + CARD].strip():
            break
        h, off = _parse_header(buf, off)
        size = _data_size(h)
        payload = buf[off:off + size]
        off += ((size + BLOCK - 1) // BLOCK) * BLOCK
        xt = str(h.get("XTENSION", "")).strip()
        if h.get("NAXIS", 0) == 0 or size == 0:
            data = None
        elif xt == "BINTABLE":
            data = _read_bintable(h, payload)
        else:
            data = _read_image(h, payload)
        hdus.append({"header": h, "data": data})
    return hdus


# ---------------------------------------------------------------------------
# writer (for tests and synthetic-data artifacts)
# ---------------------------------------------------------------------------

def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        s = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        s = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        s = f"{key:<8}= {value:>20.10G}"
    else:
        s = f"{key:<8}= '{value}'"
    if comment:
        s += f" / {comment}"
    return s[:CARD].ljust(CARD).encode("ascii")


def _pad(b: bytes, fill=b"\x00"):
    rem = len(b) % BLOCK
    return b if rem == 0 else b + fill * (BLOCK - rem)


def _header_bytes(cards):
    out = b"".join(cards) + b"END".ljust(CARD)
    return _pad(out, fill=b" ")


def write_fits_image(arr, primary: bool = True, extra_cards=None) -> bytes:
    """Serialize one IMAGE HDU."""
    arr = np.asarray(arr)
    code = {np.dtype("uint8"): 8, np.dtype("int16"): 16, np.dtype("int32"): 32,
            np.dtype("int64"): 64, np.dtype("float32"): -32,
            np.dtype("float64"): -64}[arr.dtype]
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True))
    else:
        cards.append(_card("XTENSION", "IMAGE"))
    cards.append(_card("BITPIX", code))
    cards.append(_card("NAXIS", arr.ndim))
    for i, n in enumerate(reversed(arr.shape), 1):
        cards.append(_card(f"NAXIS{i}", n))
    if not primary:
        cards += [_card("PCOUNT", 0), _card("GCOUNT", 1)]
    for k, v in (extra_cards or {}).items():
        cards.append(_card(k, v))
    dt = arr.dtype.newbyteorder(">")
    return _header_bytes(cards) + _pad(arr.astype(dt).tobytes())


def write_fits_table(cols: dict, extra_cards=None) -> bytes:
    """Serialize one BINTABLE HDU from {name: 1-D or 2-D array}."""
    names = list(cols)
    arrays = []
    tforms = []
    code_of = {np.dtype("uint8"): "B", np.dtype("int16"): "I", np.dtype("int32"): "J",
               np.dtype("int64"): "K", np.dtype("float32"): "E",
               np.dtype("float64"): "D"}
    nrow = None
    tdims = []
    for n in names:
        a = np.asarray(cols[n])
        if a.ndim == 1:
            a = a[:, None]
        tdim = None
        if a.ndim > 2:
            # multi-dim cells: flatten and record a TDIM card (FITS lists
            # the fastest-varying axis first)
            cell_shape = a.shape[1:]
            tdim = "(" + ",".join(str(d) for d in reversed(cell_shape)) + ")"
            a = a.reshape(a.shape[0], -1)
        tdims.append(tdim)
        nrow = a.shape[0] if nrow is None else nrow
        assert a.shape[0] == nrow
        arrays.append(a)
        tforms.append(f"{a.shape[1]}{code_of[a.dtype]}")
    rowbytes = sum(a.shape[1] * a.dtype.itemsize for a in arrays)
    cards = [
        _card("XTENSION", "BINTABLE"), _card("BITPIX", 8), _card("NAXIS", 2),
        _card("NAXIS1", rowbytes), _card("NAXIS2", nrow), _card("PCOUNT", 0),
        _card("GCOUNT", 1), _card("TFIELDS", len(names)),
    ]
    for i, (n, tf, td) in enumerate(zip(names, tforms, tdims), 1):
        cards += [_card(f"TTYPE{i}", n), _card(f"TFORM{i}", tf)]
        if td is not None:
            cards.append(_card(f"TDIM{i}", td))
    for k, v in (extra_cards or {}).items():
        cards.append(_card(k, v))
    rows = b"".join(
        b"".join(a[r].astype(a.dtype.newbyteorder(">")).tobytes() for a in arrays)
        for r in range(nrow)
    )
    return _header_bytes(cards) + _pad(rows)


def write_fits(path, hdu_bytes_list):
    with open(path, "wb") as fh:
        for b in hdu_bytes_list:
            fh.write(b)
