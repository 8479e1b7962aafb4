"""Minimal FITS reader and writer: a copy of ``Header``, ``read_fits``,
``read_fits_header_many`` and ``write_fits`` of ``lightcurver_tpu/io/fits.py``.

The standard's core: 2880-byte blocks, 80-char cards, primary + IMAGE
extensions, BITPIX in {8, 16, 32, 64, -32, -64}, BSCALE/BZERO, big-endian
data. Unsupported features raise rather than mis-read.
"""

import gzip

import numpy as np

BLOCK = 2880
CARD = 80


class UnsupportedFitsFeature(IOError):
    """A structurally valid FITS feature this reader refuses to guess at.

    Raised for tile-compressed images (RICE/GZIP/HCOMPRESS in a BINTABLE
    with ZIMAGE=T — decompress with `funpack` first) and table
    extensions requested as image data.  A typed refusal beats silently
    mis-reading compressed bytes as pixels (the reference inherits
    astropy's transparent handling; see docs/formats matrix)."""

_BITPIX_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


class Header:
    """Ordered FITS header: dict-like access, preserves card order."""

    def __init__(self, cards=None):
        # cards: list of (keyword, value, comment)
        self._cards = list(cards) if cards else []
        self._index = {}
        for i, (k, _, _) in enumerate(self._cards):
            self._index.setdefault(k, i)

    # -- mapping interface -------------------------------------------------
    def __contains__(self, key):
        return key.upper() in self._index

    def __getitem__(self, key):
        return self._cards[self._index[key.upper()]][1]

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        key = key.upper()
        comment = ""
        if isinstance(value, tuple):
            value, comment = value
        if key in self._index:
            i = self._index[key]
            self._cards[i] = (key, value, comment or self._cards[i][2])
        else:
            self._index[key] = len(self._cards)
            self._cards.append((key, value, comment))

    def __delitem__(self, key):
        key = key.upper()
        i = self._index.pop(key)
        del self._cards[i]
        self._index = {}
        for j, (k, _, _) in enumerate(self._cards):
            self._index.setdefault(k, j)

    def keys(self):
        return [k for k, _, _ in self._cards if k not in ("COMMENT",
                                                          "HISTORY", "")]

    def items(self):
        return [(k, v) for k, v, _ in self._cards]

    def cards(self):
        return list(self._cards)

    def update(self, other):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v

    def copy(self):
        return Header(self._cards)

    def __len__(self):
        return len(self._cards)


def _parse_value(raw):
    """Parse the value field of a card."""
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # FITS strings: '' escapes a quote; value ends at unescaped '
        out, i = [], 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _parse_card(card):
    key = card[:8].strip()
    if key == "CONTINUE":
        # long-string continuation (no '= '); value starts at the quote
        rest = card[8:]
    elif key in ("COMMENT", "HISTORY") or not card[8:10] == "= ":
        return key, card[8:].strip(), ""
    else:
        rest = card[10:]
    # split off comment at the first '/' outside a string
    in_str = False
    comment = ""
    for i, ch in enumerate(rest):
        if ch == "'":
            in_str = not in_str
        elif ch == "/" and not in_str:
            comment = rest[i + 1:].strip()
            rest = rest[:i]
            break
    return key, _parse_value(rest), comment


def _merge_continue(cards):
    """Concatenate FITS long-string values (the CONTINUE convention).

    A string value ending in ``&`` continues on the next card when that
    card's keyword is CONTINUE; the ``&`` is dropped on concatenation.
    CONTINUE cards without a preceding ``&``-terminated string are left
    as-is (malformed input; harmless).
    """
    merged = []
    for key, value, comment in cards:
        if (key == "CONTINUE" and merged
                and isinstance(merged[-1][1], str)
                and merged[-1][1].endswith("&")
                and isinstance(value, str)):
            pkey, pval, pcom = merged[-1]
            merged[-1] = (pkey, pval[:-1] + value, comment or pcom)
            continue
        merged.append((key, value, comment))
    return merged


def _format_long_string(key_padded, value, comment):
    """Emit a long string as a value card + CONTINUE cards (the FITS
    long-string convention); returns the concatenated 80-char cards."""
    chunks, cur, cur_len = [], [], 0
    for ch in value:
        esc = "''" if ch == "'" else ch
        if cur_len + len(esc) > CARD - 14:   # room for quotes + '&'
            chunks.append("".join(cur))
            cur, cur_len = [], 0
        cur.append(esc)
        cur_len += len(esc)
    chunks.append("".join(cur))
    cards = [f"{key_padded}= '{chunks[0]}&'"[:CARD].ljust(CARD)]
    for i, chunk in enumerate(chunks[1:], start=1):
        amp = "&" if i < len(chunks) - 1 else ""
        body = f"CONTINUE  '{chunk}{amp}'"
        if not amp and comment:
            body += f" / {comment}"
        cards.append(body[:CARD].ljust(CARD))
    return "".join(cards)


def _format_card(key, value, comment=""):
    key = key.upper()[:8].ljust(8)
    if key.strip() in ("COMMENT", "HISTORY"):
        # commentary keywords carry free text in columns 9-80 and MUST
        # NOT have a value indicator (the '= ' form is forbidden for
        # them by the standard and garbles round-trips)
        return (key + str(value))[:CARD].ljust(CARD)
    if value is None:
        body = ""
    elif isinstance(value, (bool, np.bool_)):
        # np.bool_ is NOT a subclass of bool: without the explicit case
        # a numpy comparison result would be written as the STRING
        # 'True' (truthy even when 'False' on re-read)
        body = "T".rjust(20) if value else "F".rjust(20)
    elif isinstance(value, (int, np.integer)):
        body = str(int(value)).rjust(20)
    elif isinstance(value, (float, np.floating)) \
            and not np.isfinite(value):
        # FITS has no non-finite numeric card value; repr() would emit
        # the ILLEGAL bare token 'nan'.  A quoted string is legal FITS
        # and preserves the information (raw instrument headers do
        # carry such cards; re-reads see the string 'nan', which
        # float()s back for any consumer that expects a number)
        body = f"'{float(value)!s:<8s}'"
    elif isinstance(value, (float, np.floating)):
        if value != 0 and (abs(value) >= 1e15 or abs(value) < 1e-9):
            body = np.format_float_scientific(value, precision=12)
        else:
            body = repr(float(value))
        # FITS mandates an UPPERCASE exponent letter; repr() emits e.g.
        # '5.5e-05' for the WCS CD / SIP coefficient range
        body = body.replace("e", "E").rjust(20)
    else:
        s = str(value).replace("'", "''")
        # 80-char card minus "KEY     = " and the two quotes leaves 68
        # chars; longer strings go out as CONTINUE cards (the FITS
        # long-string convention, round-tripped by _merge_continue)
        if len(s) > CARD - 12:
            return _format_long_string(key, str(value), comment)
        body = f"'{s:<8s}'"
    card = f"{key}= {body}"
    if comment:
        card += f" / {comment}"
    return card[:CARD].ljust(CARD)


def _read_header(fh):
    """Read header blocks until END; returns (Header, bytes_consumed)."""
    cards = []
    nbytes = 0
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            if not cards and not block:
                return None, 0  # clean EOF between HDUs
            raise IOError("truncated FITS header")
        nbytes += BLOCK
        text = block.decode("latin-1")
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i:i + CARD]
            # the END card's KEYWORD is exactly 'END' — a prefix test
            # would also match keywords like ENDTIME/ENDEXP and
            # truncate the header there (with a wrong data offset when
            # the real END sits in a later block)
            if card[:8].strip() == "END":
                done = True
                break
            if card.strip():
                cards.append(_parse_card(card))
        if done:
            return Header(_merge_continue(cards)), nbytes


def _data_size_bytes(header):
    naxis = int(header.get("NAXIS", 0))
    if naxis == 0:
        return 0, ()
    shape = tuple(int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    nel = int(np.prod(shape))
    gcount = int(header.get("GCOUNT", 1))
    pcount = int(header.get("PCOUNT", 0))
    bitpix = int(header["BITPIX"])
    nbytes = abs(bitpix) // 8 * gcount * (pcount + nel)
    return nbytes, shape


def read_fits(path, hdu_index=0, header_only=False, memmap=False):
    """Read one HDU: returns ``(data, header)``; data None for NAXIS=0.

    Integer data with BSCALE/BZERO is converted to float32 (matching the
    pipeline's immediate ADU -> e-/s conversion); float data keeps its
    precision as float32/float64.

    ``memmap=True`` returns a read-only ``np.memmap`` view of unscaled
    float data instead of loading it — slicing (e.g. the importation
    trim) then touches only the needed pages of a wide-field mosaic
    (mirrors the reference's memmap import path, reference
    processes/frame_importation.py:33-60).  Scaled/integer data needs a
    full-array conversion anyway, so it falls back to an eager read.

    Whole-file gzip (``.fits.gz``, detected by magic bytes regardless of
    extension) is decompressed transparently; memmap is then impossible
    and falls back to an eager read.  Tile-compressed images (RICE etc.)
    raise :class:`UnsupportedFitsFeature` — see its docstring.
    """
    with open(path, "rb") as raw_fh:
        gzipped = raw_fh.read(2) == b"\x1f\x8b"
        raw_fh.seek(0)
        fh = gzip.open(raw_fh, "rb") if gzipped else raw_fh
        idx = 0
        while True:
            header, _ = _read_header(fh)
            if header is None:
                raise IndexError(f"HDU {hdu_index} not found in {path}")
            nbytes, shape = _data_size_bytes(header)
            if idx == hdu_index:
                if header_only or not shape:
                    return None, header
                xtension = str(header.get("XTENSION", "IMAGE")).strip()
                if header.get("ZIMAGE", False):
                    raise UnsupportedFitsFeature(
                        f"HDU {hdu_index} of {path} is a tile-compressed "
                        f"image ({header.get('ZCMPTYPE', 'unknown')!s}); "
                        "decompress with `funpack` (cfitsio) before "
                        "importation")
                if xtension not in ("IMAGE", "IUEIMAGE"):
                    raise UnsupportedFitsFeature(
                        f"HDU {hdu_index} of {path} is a {xtension} "
                        "extension, not image data")
                bitpix = int(header["BITPIX"])
                if bitpix not in _BITPIX_DTYPES:
                    raise UnsupportedFitsFeature(
                        f"BITPIX={bitpix} in {path} is not a standard "
                        "FITS image type")
                dtype = _BITPIX_DTYPES[bitpix]
                needs_scaling = (dtype.kind in "iu"
                                 or header.get("BSCALE", 1) != 1
                                 or header.get("BZERO", 0) != 0)
                if memmap and not needs_scaling and not gzipped:
                    # (gzipped: file offsets are compressed-stream
                    # positions — memmap is impossible, read eagerly)
                    data = np.memmap(path, dtype=dtype, mode="r",
                                     offset=fh.tell(), shape=shape)
                    return data, header
                raw = fh.read(nbytes)
                if len(raw) < nbytes:
                    raise IOError("truncated FITS data")
                data = np.frombuffer(raw, dtype=dtype).reshape(shape)
                bscale = header.get("BSCALE", 1)
                bzero = header.get("BZERO", 0)
                if dtype.kind in "iu" or bscale != 1 or bzero != 0:
                    # scale in the precision of the source: float64 for
                    # any type whose significand exceeds float32's 24
                    # bits — 64-bit types AND 32-bit integers (the
                    # standard unsigned-32 encoding BITPIX=32 +
                    # BZERO=2^31 would otherwise lose up to ~128 counts
                    # to float32 quantization)
                    out = (np.float64
                           if dtype.itemsize == 8
                           or (dtype.kind in "iu" and dtype.itemsize >= 4)
                           else np.float32)
                    data = data.astype(out) * out(bscale) + out(bzero)
                else:
                    data = data.astype(data.dtype.newbyteorder("="))
                return data, header
            # skip this HDU's data (padded to block size)
            fh.seek((nbytes + BLOCK - 1) // BLOCK * BLOCK, 1)
            idx += 1


def read_fits_header_many(path, hdu_indexes):
    """One Header merged from several HDUs' (the config's
    ``hdu_header_indexes``), without COMMENT and HISTORY cards."""
    merged = Header()
    for idx in hdu_indexes:
        _, h = read_fits(path, hdu_index=idx, header_only=True)
        for k, v, c in h.cards():
            if k not in ("COMMENT", "HISTORY", ""):
                merged[k] = (v, c)
    return merged


_STRUCTURAL = ("SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "NAXIS3",
               "EXTEND", "BSCALE", "BZERO", "XTENSION", "PCOUNT", "GCOUNT")


def write_fits(path, data, header=None):
    """Write a single-HDU FITS file (float32 or float64 image)."""
    data = np.asarray(data)
    if data.dtype == np.float64:
        bitpix = -64
    else:
        data = data.astype(np.float32)
        bitpix = -32
    cards = [
        _format_card("SIMPLE", True, "conforms to FITS standard"),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", data.ndim),
    ]
    for i, nax in enumerate(reversed(data.shape)):
        cards.append(_format_card(f"NAXIS{i + 1}", int(nax)))
    if header is not None:
        for k, v, c in header.cards():
            if k in _STRUCTURAL or k == "END" or not k:
                continue
            cards.append(_format_card(k, v, c))
    cards.append("END".ljust(CARD))
    head = "".join(cards).encode("latin-1")
    head += b" " * (-len(head) % BLOCK)

    payload = data.astype(data.dtype.newbyteorder(">")).tobytes()
    payload += b"\0" * (-len(payload) % BLOCK)
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(payload)
