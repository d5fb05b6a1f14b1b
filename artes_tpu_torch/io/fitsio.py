"""Minimal FITS image I/O (pure NumPy).

The reference pipeline communicates between its stages exclusively through
FITS files: the atmosphere artifact (atmosphere.py:449-460 written, read by
``get_atmosphere`` ARTES.f90:2054-2235 via cfitsio) and the per-species
opacity files (4 x n_lambda opacity table + 180 x 16 x n_lambda scattering
matrices). This module implements the subset of FITS needed for those
artifacts: image HDUs (primary + IMAGE extensions) of BITPIX 8/16/32/64/-32/-64
with EXTNAME, written in the same layout astropy produced for the reference
(first HDU is the primary and carries data).

Copy of ``artes_tpu.io.fitsio``: the pure-Python reader and writer are the
format authority; :func:`read_fits_native` reads the same files through the
C++ library ``native/fits/fitsread.cc`` (the cfitsio-equivalent bulk
reader, built with g++ by ``_build`` at first use), and raises where the
original returned ``None`` for its caller to fall back.
"""

from __future__ import annotations

import os

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_TO_DTYPE = {
    8: ">u1",
    16: ">i2",
    32: ">i4",
    64: ">i8",
    -32: ">f4",
    -64: ">f8",
}
_DTYPE_TO_BITPIX = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.int32): 32,
    np.dtype(np.int64): 64,
    np.dtype(np.float32): -32,
    np.dtype(np.float64): -64,
}


def _card(keyword: str, value, comment: str = "") -> bytes:
    """Format one 80-byte FITS header card (fixed format)."""
    kw = keyword.ljust(8)[:8]
    if value is None:
        text = kw + (" " + comment if comment else "")
    else:
        if isinstance(value, bool):
            val = "T" if value else "F"
            body = val.rjust(20)
        elif isinstance(value, (int, np.integer)):
            body = str(int(value)).rjust(20)
        elif isinstance(value, float):
            body = repr(value).rjust(20)
        else:  # string
            s = str(value).ljust(8)
            body = "'%s'" % s
        text = kw + "= " + body
        if comment:
            text += " / " + comment
    return text.ljust(CARD)[:CARD].encode("ascii")


def _pad_block(b: bytes, fill: bytes = b" ") -> bytes:
    rem = len(b) % BLOCK
    if rem:
        b += fill * (BLOCK - rem)
    return b


def _header_bytes(cards: list[bytes]) -> bytes:
    return _pad_block(b"".join(cards) + _card("END", None))


def _serialize_hdu(name: str | None, data: np.ndarray | None, primary: bool) -> bytes:
    cards = []
    if primary:
        cards.append(_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_card("XTENSION", "IMAGE", "Image extension"))
    if data is None:
        cards.append(_card("BITPIX", 8))
        cards.append(_card("NAXIS", 0))
    else:
        data = np.asarray(data)
        bitpix = _DTYPE_TO_BITPIX[np.dtype(data.dtype.newbyteorder("="))]
        cards.append(_card("BITPIX", bitpix))
        cards.append(_card("NAXIS", data.ndim))
        # NAXIS1 is the fastest-varying (last numpy) axis.
        for i, n in enumerate(reversed(data.shape)):
            cards.append(_card("NAXIS%d" % (i + 1), n))
    if primary:
        cards.append(_card("EXTEND", True))
    else:
        cards.append(_card("PCOUNT", 0))
        cards.append(_card("GCOUNT", 1))
    if name:
        cards.append(_card("EXTNAME", name))
    out = _header_bytes(cards)
    if data is not None and data.size:
        raw = np.ascontiguousarray(data, dtype=data.dtype.newbyteorder(">")).tobytes()
        out += _pad_block(raw, b"\x00")
    return out


def write_fits(path, hdus) -> None:
    """Write a FITS file.

    ``hdus`` is a sequence of ``(name, array)`` pairs. Mirroring how astropy
    wrote the reference artifacts, the first HDU becomes the primary HDU and
    carries its data; the rest are IMAGE extensions.
    """
    buf = b""
    for i, (name, data) in enumerate(hdus):
        buf += _serialize_hdu(name, None if data is None else np.asarray(data), primary=(i == 0))
    with open(path, "wb") as fh:
        fh.write(buf)


def _parse_header(buf: bytes, off: int):
    cards = {}
    pos = off
    while True:
        block = buf[pos : pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        pos += BLOCK
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD].decode("ascii", errors="replace")
            kw = card[:8].strip()
            if kw == "END":
                done = True
                break
            if card[8:10] != "= ":
                continue
            raw = card[10:]
            slash = _value_end(raw)
            val = raw[:slash].strip()
            if val.startswith("'"):
                value = val[1 : val.rfind("'")].rstrip()
            elif val == "T":
                value = True
            elif val == "F":
                value = False
            else:
                try:
                    value = int(val)
                except ValueError:
                    try:
                        value = float(val.replace("D", "E").replace("d", "e"))
                    except ValueError:
                        value = val
            cards[kw] = value
        if done:
            break
    return cards, pos


def _value_end(raw: str) -> int:
    """Index where the value field ends (handles '/' inside quoted strings)."""
    if raw.lstrip().startswith("'"):
        start = raw.index("'")
        end = raw.find("'", start + 1)
        while end != -1 and end + 1 < len(raw) and raw[end + 1] == "'":
            end = raw.find("'", end + 2)
        return len(raw) if end == -1 else end + 1
    slash = raw.find("/")
    return len(raw) if slash == -1 else slash


def read_fits(path):
    """Read all image HDUs: returns a list of ``(extname_or_None, ndarray)``."""
    with open(path, "rb") as fh:
        buf = fh.read()
    hdus = []
    pos = 0
    while pos < len(buf):
        cards, pos = _parse_header(buf, pos)
        naxis = int(cards.get("NAXIS", 0))
        shape = tuple(int(cards["NAXIS%d" % i]) for i in range(naxis, 0, -1))
        bitpix = int(cards["BITPIX"])
        name = cards.get("EXTNAME")
        if naxis == 0 or 0 in shape:
            hdus.append((name, None))
            continue
        dtype = np.dtype(_BITPIX_TO_DTYPE[bitpix])
        nbytes = dtype.itemsize * int(np.prod(shape))
        data = np.frombuffer(buf[pos : pos + nbytes], dtype=dtype).reshape(shape)
        data = data.astype(dtype.newbyteorder("="))
        pos += nbytes
        if pos % BLOCK:
            pos += BLOCK - pos % BLOCK
        hdus.append((name, data))
    return hdus


_FITS_ERRORS = {-1: "cannot open the file", -2: "truncated header", -3: "no such HDU",
                -4: "wrong element count", -5: "truncated data"}


def _native_lib():
    """The native reader's library, built on first use, its functions typed."""
    import ctypes

    from artes_tpu_torch import _build

    lib = _build.load_host("libartesfits")
    c_long_p = ctypes.POINTER(ctypes.c_long)
    lib.artes_fits_scan.argtypes = [ctypes.c_char_p, c_long_p]
    lib.artes_fits_hdu_info.argtypes = [ctypes.c_char_p, ctypes.c_int, c_long_p, c_long_p,
                                        ctypes.c_char_p]
    lib.artes_fits_read.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    for fn in (lib.artes_fits_scan, lib.artes_fits_hdu_info, lib.artes_fits_read):
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, path, what: str) -> None:
    if rc:
        raise OSError(f"native FITS reader, {what} of {path}: "
                      f"{_FITS_ERRORS.get(rc, 'error')} ({rc})")


def read_fits_native(path):
    """Read all image HDUs through the native library: a list of
    ``(extname_or_None, float64 ndarray or None)``. A build or read error
    raises."""
    import ctypes

    lib = _native_lib()
    cpath = os.fspath(path).encode()
    n = ctypes.c_long(0)
    _check(lib.artes_fits_scan(cpath, ctypes.byref(n)), path, "scan")
    hdus = []
    for i in range(n.value):
        ndim = ctypes.c_long(0)
        shape = (ctypes.c_long * 8)()
        name = ctypes.create_string_buffer(72)
        _check(lib.artes_fits_hdu_info(cpath, i, ctypes.byref(ndim), shape, name), path,
               f"header {i}")
        dims = [shape[k] for k in range(ndim.value)]
        ext = name.value.decode() or None
        if ndim.value == 0 or 0 in dims:
            hdus.append((ext, None))
            continue
        out = np.empty(int(np.prod(dims)), np.float64)
        _check(lib.artes_fits_read(cpath, i, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                                   out.size), path, f"data {i}")
        # FITS order: shape[0] = NAXIS1 is the fastest axis, numpy's last
        hdus.append((ext, out.reshape(tuple(reversed(dims)))))
    return hdus


def read_fits_map(path):
    """Read a FITS file into ``{extname_lower: array}`` (unnamed HDUs get hdu<i>)."""
    out = {}
    for i, (name, data) in enumerate(read_fits(path)):
        key = (name or f"hdu{i}").lower()
        out[key] = data
    return out
