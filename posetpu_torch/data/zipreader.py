"""Images read from a plain path or from a zip archive
(``archive.zip@/inner/path``).

Equivalent of lib/utils/zipreader.py:24-47. One ``ZipFile`` is opened per
archive and shared; a member's bytes are read under a lock (the archive's
file position is shared) and decoded by cv2 outside it, so the loader's
threads overlap their decodes, which are most of the time.
"""

from __future__ import annotations

import threading
import zipfile

import numpy as np

_cache: dict[str, zipfile.ZipFile] = {}
_lock = threading.Lock()


def split_zip_path(path: str) -> tuple[str, str]:
    """'/a/b.zip@/inner/img.jpg' -> ('/a/b.zip', 'inner/img.jpg')."""
    if "@" not in path:
        raise ValueError(f"not a zip path: {path}")
    zip_path, inner = path.split("@", 1)
    return zip_path, inner.lstrip("/")


def is_zip_path(path: str) -> bool:
    return "@" in path


def _get_zip(zip_path: str) -> zipfile.ZipFile:
    with _lock:
        zf = _cache.get(zip_path)
        if zf is None:
            zf = zipfile.ZipFile(zip_path, "r")
            _cache[zip_path] = zf
        return zf


def read_bytes(path: str) -> bytes:
    """The file's bytes, from a plain path or a zip member."""
    if is_zip_path(path):
        zip_path, inner = split_zip_path(path)
        zf = _get_zip(zip_path)
        with _lock:
            return zf.read(inner)
    with open(path, "rb") as f:
        return f.read()


def imread(path: str, flags: int | None = None) -> np.ndarray:
    """An image (BGR, as cv2 reads it; ``flags`` cv2's, IMREAD_COLOR unless
    given); FileNotFoundError naming ``path`` where it is missing or does
    not decode."""
    import cv2

    try:
        data = read_bytes(path)
    except (OSError, KeyError) as e:
        raise FileNotFoundError(path) from e
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR if flags is None else flags)
    if img is None:
        raise FileNotFoundError(path)
    return img
