"""EXIF orientation parsing and application: the port's own copy of
``vision_tpu/io/_exif.py`` (the port imports nothing of ``vision_tpu``).

The reference parses the EXIF APP1/TIFF block in
``torchvision/csrc/io/image/cpu/exif.h`` (``fetch_exif_orientation``) and
applies the orientation as flips and transposes after the decode. The
parsing here walks the raw byte stream (the JPEG APP1 segments, the PNG
eXIf chunk) with the reference's guard rules (mismatched endianness bytes
read big-endian; a read out of range acts as the 0xFFFF INCORRECT_TAG
sentinel; the first 0x0112 entry wins). The orientation (tag 0x0112,
values 1..8) is applied to CHW tensors, the port's layout, as the
reference's table stands.
"""

from __future__ import annotations

_ORIENTATION_TAG = 0x0112
_INCORRECT_TAG = 0xFFFF
_EXIF_PREFIX = b"Exif\x00\x00"


def _fetch_exif_orientation(buf: bytes) -> int:
    """TIFF IFD0 walk for tag 0x0112. ``buf`` starts at the byte-order
    mark (after any ``Exif\\0\\0`` prefix). Returns -1 when absent.

    Mirrors reference ``exif.h:fetch_exif_orientation`` guard-for-guard.
    """
    n = len(buf)

    # get_endianness (exif.h:92): both bytes must match; 'I' -> little,
    # 'M' -> big, anything else -> 0, which the reference's get_uint16
    # then reads as big-endian.
    if n < 1 or (n > 1 and buf[0] != buf[1]):
        little = False
    elif buf[0] == 0x49:  # 'I'
        little = True
    else:
        little = False  # 'M' or invalid

    def u16(off: int) -> int:
        if off < 0 or off + 1 >= n:
            return _INCORRECT_TAG
        if little:
            return buf[off] | (buf[off + 1] << 8)
        return (buf[off] << 8) | buf[off + 1]

    def u32(off: int) -> int:
        if off < 0 or off + 3 >= n:
            return _INCORRECT_TAG
        return int.from_bytes(
            buf[off : off + 4], "little" if little else "big"
        )

    if u16(2) != 0x2A:  # REQ_EXIF_TAG_MARK
        return -1
    off = u32(4)
    num_entry = u16(off)
    off += 2
    for _ in range(num_entry):
        tag = u16(off)
        if tag == _INCORRECT_TAG:
            break
        if tag == _ORIENTATION_TAG:
            return u16(off + 8)
        off += 12  # tiff_field_size
    return -1


def parse_jpeg_exif_orientation(data: bytes) -> int:
    """Scan JPEG segments for the APP1/Exif block; -1 when absent.

    Container-level analog of libjpeg's saved-marker walk in
    ``exif.h:fetch_jpeg_exif_orientation``.
    """
    if data[:2] != b"\xff\xd8":
        return -1
    i = 2
    n = len(data)
    while i + 3 < n:
        if data[i] != 0xFF:
            return -1  # desynced stream; bail like a failed marker scan
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        i += 2
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            continue  # standalone markers, no length field
        if marker in (0xD9, 0xDA):  # EOI / SOS: metadata segment zone over
            break
        if i + 1 >= n:
            break
        seglen = (data[i] << 8) | data[i + 1]
        if seglen < 2:
            break
        if marker == 0xE1 and data[i + 2 : i + 8] == _EXIF_PREFIX:
            # reference: data_length (seglen-2) must exceed the 6-byte
            # prefix (exif.h:fetch_jpeg_exif_orientation start_offset)
            if seglen - 2 <= 6:
                return -1
            return _fetch_exif_orientation(bytes(data[i + 8 : i + seglen]))
        i += seglen
    return -1


def parse_png_exif_orientation(data: bytes) -> int:
    """Scan PNG chunks for eXIf; -1 when absent.

    The analog of libpng's ``png_get_eXIf_1`` consumption in
    ``exif.h:fetch_png_exif_orientation``. PNG stores the TIFF block
    directly (no ``Exif\\0\\0`` prefix), but tolerate one if present.
    """
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return -1
    i = 8
    n = len(data)
    while i + 8 <= n:
        length = int.from_bytes(data[i : i + 4], "big")
        ctype = data[i + 4 : i + 8]
        if ctype == b"eXIf":
            payload = bytes(data[i + 8 : i + 8 + length])
            if payload[:6] == _EXIF_PREFIX:
                payload = payload[6:]
            return _fetch_exif_orientation(payload)
        if ctype == b"IEND":
            break
        i += 12 + length  # length + type + data + crc
    return -1


def exif_orientation_transform(img, orientation: int):
    """Apply EXIF orientation to a ``(..., C, H, W)`` tensor.

    The reference's CHW table (``exif.h:233-256``) as it stands: ``flip(-1)``
    flips the width, ``flip(-2)`` the height, ``transpose(-1, -2)`` swaps
    them. The result is contiguous."""
    if orientation == 2:  # TR: horizontal flip
        img = img.flip(-1)
    elif orientation == 3:  # BR: 180 rotation
        img = img.flip(-2).flip(-1)
    elif orientation == 4:  # BL: vertical flip
        img = img.flip(-2)
    elif orientation == 5:  # LT: transpose
        img = img.transpose(-1, -2)
    elif orientation == 6:  # RT: rotate 90 CW
        img = img.transpose(-1, -2).flip(-1)
    elif orientation == 7:  # RB: transpose + 180
        img = img.transpose(-1, -2).flip(-2).flip(-1)
    elif orientation == 8:  # LB: rotate 270 CW
        img = img.transpose(-1, -2).flip(-2)
    # 1 / absent / invalid: identity (exif.h:236,255)
    return img.contiguous()
