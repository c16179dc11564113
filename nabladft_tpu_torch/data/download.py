"""HTTP download with ETag/MD5 validation and resume-safe temp files.

The port of ``nabladft_tpu/data/download.py`` (urllib only). Mirrors the
validation semantics of the reference's nablaDFT/utils/download.py:9-81: a file is valid if its md5 matches the
expected ETag; multipart ETags ("<hash>-<n>") are validated by re-chunking
the file into n equal parts, hashing each part, and hashing the
concatenation of the digests (S3 multipart convention).
"""

from __future__ import annotations

import hashlib
import logging
import math
import shutil
import urllib.request
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_CHUNK = 1 << 20  # 1 MiB read granularity


def file_md5(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def multipart_etag(path: Path, num_parts: int) -> str:
    """S3 multipart ETag: md5 of concatenated per-part md5 digests."""
    size = path.stat().st_size
    part_size = math.ceil(size / num_parts)
    digests = []
    with open(path, "rb") as f:
        for _ in range(num_parts):
            h = hashlib.md5()
            remaining = part_size
            while remaining > 0:
                chunk = f.read(min(_CHUNK, remaining))
                if not chunk:
                    break
                h.update(chunk)
                remaining -= len(chunk)
            digests.append(h.digest())
    return hashlib.md5(b"".join(digests)).hexdigest() + f"-{num_parts}"


def validate_file(path: Path, etag: Optional[str]) -> bool:
    if etag is None:
        return path.exists()
    if not path.exists():
        return False
    if "-" in etag:
        num_parts = int(etag.rsplit("-", 1)[1])
        return multipart_etag(path, num_parts) == etag
    return file_md5(path) == etag


def download_file(
    url: str,
    dest: Path,
    etag: Optional[str] = None,
    desc: str = "",
    progress: bool = True,
) -> Path:
    """Download `url` to `dest`, skipping if a validated copy already exists.

    Raises RuntimeError if the downloaded file fails ETag validation
    (reference behavior: utils/download.py:26-31 raises on hash mismatch).
    """
    dest = Path(dest)
    if validate_file(dest, etag):
        logger.info("%s already present and valid", dest)
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    logger.info("downloading %s -> %s %s", url, dest, desc)
    with urllib.request.urlopen(url, timeout=600) as resp, open(tmp, "wb") as out:
        total = int(resp.headers.get("Content-Length") or 0)
        done = 0
        while True:
            chunk = resp.read(_CHUNK)
            if not chunk:
                break
            out.write(chunk)
            done += len(chunk)
            if progress and total and done % (64 * _CHUNK) < _CHUNK:
                logger.info("%s: %.1f%%", desc or dest.name, 100.0 * done / total)
    shutil.move(str(tmp), str(dest))
    if etag is not None and not validate_file(dest, etag):
        raise RuntimeError(f"checksum mismatch for {dest} (expected etag {etag})")
    return dest
