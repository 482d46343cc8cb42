"""Image processing: on-read resizing + EXIF orientation fix."""

from .resizing import fix_orientation, resize_image  # noqa: F401
