"""On-read image resizing + write-time EXIF orientation normalization.

The port's copy of ``seaweedfs_tpu/images/resizing.py``. It imports PIL
at its top, so the volume server imports this package only inside the
handlers that resize or reorient an image.

Behavioral model: weed/images/resizing.go:16 (?width=&height=&mode= on
volume reads, jpg/png/gif) and orientation.go (EXIF fix applied once at
write time for jpegs).
"""

from __future__ import annotations

import io

from PIL import Image, ImageOps

RESIZABLE = {"image/jpeg", "image/png", "image/gif"}
_FORMATS = {"image/jpeg": "JPEG", "image/png": "PNG", "image/gif": "GIF"}


def _sniff(data: bytes) -> str | None:
    if data[:3] == b"\xff\xd8\xff":
        return "image/jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "image/png"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "image/gif"
    return None


def resize_image(
    data: bytes, width: int = 0, height: int = 0, mode: str = ""
) -> bytes:
    """Resize if the payload is a known image; pass through otherwise.

    mode "" → aspect-preserving fit inside (w,h); "fit" → exact size,
    letterboxed; "fill" → exact size, center-cropped (resizing.go:24-44).
    """
    mime = _sniff(data)
    if mime is None or (width <= 0 and height <= 0):
        return data
    img = Image.open(io.BytesIO(data))
    w0, h0 = img.size
    width = width or w0
    height = height or h0
    if mode == "fit":
        out = ImageOps.pad(img, (width, height))
    elif mode == "fill":
        out = ImageOps.fit(img, (width, height))
    else:
        img.thumbnail((width, height))
        out = img
    buf = io.BytesIO()
    if out.mode in ("RGBA", "P") and mime == "image/jpeg":
        out = out.convert("RGB")
    out.save(buf, format=_FORMATS[mime])
    return buf.getvalue()


def fix_orientation(data: bytes) -> bytes:
    """Apply the EXIF orientation tag to jpeg pixels (orientation.go)."""
    if _sniff(data) != "image/jpeg":
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fixed = ImageOps.exif_transpose(img)
        if fixed is img:
            return data
        buf = io.BytesIO()
        fixed.save(buf, format="JPEG", quality=95)
        return buf.getvalue()
    except Exception:
        return data
