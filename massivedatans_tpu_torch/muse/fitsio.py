"""Minimal FITS image reader (standalone; uses astropy when available).

The MUSE pipeline (reference ``musefuse.py:33-42``) needs only: open a FITS
file, find the ``DATA`` and ``STAT`` image extensions, read their 3-D float
arrays and the ``CD3_3``/``CRVAL3`` wavelength WCS cards. This reader covers
exactly that subset of the FITS standard: 2880-byte header blocks of 80-char
cards, BITPIX in {8,16,32,64,-32,-64}, BSCALE/BZERO, big-endian data.

The port's own copy of ``massivedatans_tpu/muse/fitsio.py``:
same names and file format.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880
_CARD = 80

_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


class HDU:
    def __init__(self, header: dict, data):
        self.header = header
        self.data = data

    @property
    def name(self):
        return str(self.header.get("EXTNAME", "")).strip()


def _parse_value(raw: str):
    raw = raw.split("/")[0].strip()
    if raw.startswith("'"):
        return raw.strip("'").strip()
    if raw in ("T", "F"):
        return raw == "T"
    try:
        if any(c in raw for c in ".ED"):
            return float(raw.replace("D", "E"))
        return int(raw)
    except ValueError:
        return raw


def _read_header(fh) -> dict | None:
    header = {}
    while True:
        block = fh.read(_BLOCK)
        if len(block) < _BLOCK:
            return None if not header else header
        for i in range(0, _BLOCK, _CARD):
            card = block[i:i + _CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return header
            if card[8:10] == "= ":
                header[key] = _parse_value(card[10:])


def _data_size(header: dict) -> tuple[int, tuple]:
    naxis = int(header.get("NAXIS", 0))
    if naxis == 0:
        return 0, ()
    shape = tuple(
        int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)
    )  # C-order: slowest axis first
    n = 1
    for s in shape:
        n *= s
    return n, shape


def fits_open(path: str):
    """Return a list of HDU objects (astropy-compatible enough for us)."""
    try:
        import astropy.io.fits as pyfits  # prefer the real thing

        with pyfits.open(path) as hdus:
            return [HDU(dict(h.header), None if h.data is None else
                        np.array(h.data)) for h in hdus]
    except ImportError:
        pass

    hdus = []
    with open(path, "rb") as fh:
        while True:
            header = _read_header(fh)
            if header is None:
                break
            n, shape = _data_size(header)
            data = None
            if n > 0:
                dtype = _DTYPES[int(header["BITPIX"])]
                nbytes = n * dtype.itemsize
                raw = fh.read(nbytes)
                if len(raw) < nbytes:
                    raise IOError(f"truncated FITS data in {path}")
                pad = (-nbytes) % _BLOCK
                fh.read(pad)
                data = np.frombuffer(raw, dtype=dtype).reshape(shape)
                data = data.astype(dtype.newbyteorder("="))
                bscale = header.get("BSCALE", 1)
                bzero = header.get("BZERO", 0)
                if bscale != 1 or bzero != 0:
                    data = data * bscale + bzero
            hdus.append(HDU(header, data))
    return hdus


def get_hdu(hdus, name: str) -> HDU:
    for h in hdus:
        if h.name == name:
            return h
    raise KeyError(f"no HDU named {name!r}")


def fits_write(path: str, arrays: dict, extra_cards: dict | None = None):
    """Write named 3-D float32 image extensions (test fixtures / synth cubes)."""

    def card(key, val, comment=""):
        if isinstance(val, bool):
            sval = "T" if val else "F"
            return f"{key:<8}= {sval:>20} / {comment}"[:80].ljust(80)
        if isinstance(val, str):
            return f"{key:<8}= '{val}'".ljust(80)
        return f"{key:<8}= {val:>20} / {comment}"[:80].ljust(80)

    def write_block(fh, cards):
        text = "".join(cards) + "END".ljust(80)
        pad = (-len(text)) % _BLOCK
        fh.write((text + " " * pad).encode("ascii"))

    with open(path, "wb") as fh:
        write_block(fh, [card("SIMPLE", True), card("BITPIX", 8),
                         card("NAXIS", 0), card("EXTEND", True)])
        for name, arr in arrays.items():
            arr = np.asarray(arr, np.float32)
            cards = [card("XTENSION", "IMAGE"), card("BITPIX", -32),
                     card("NAXIS", arr.ndim)]
            for i, s in enumerate(arr.shape[::-1]):
                cards.append(card(f"NAXIS{i+1}", s))
            cards += [card("PCOUNT", 0), card("GCOUNT", 1),
                      card("EXTNAME", name)]
            for k, v in (extra_cards or {}).items():
                cards.append(card(k, v))
            write_block(fh, cards)
            raw = arr.astype(">f4").tobytes()
            fh.write(raw)
            fh.write(b"\0" * ((-len(raw)) % _BLOCK))
