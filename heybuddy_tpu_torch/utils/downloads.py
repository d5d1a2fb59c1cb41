"""
The cache directory and the downloader of hosted artifacts (the precalculated
feature sets).

``check_download_file`` fetches a URL into the cache unless the file is
already there (and matches its sha256, where one is known). With
``HEYBUDDY_OFFLINE=1`` it raises instead of opening a connection, so that an
air-gapped run fails at once rather than at a network timeout. Callers treat
every failure as "artifact absent".
"""

from __future__ import annotations

import hashlib
import os
import shutil
import urllib.request
from typing import Optional

from heybuddy_tpu_torch.utils.log import logger

__all__ = ["get_cache_dir", "check_download_file", "file_sha256", "file_is_downloaded"]


def get_cache_dir(subdir: str = "") -> str:
    """``HEYBUDDY_CACHE_DIR`` (default ``~/.cache/heybuddy-tpu``) / ``subdir``, created."""
    base = os.environ.get(
        "HEYBUDDY_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "heybuddy-tpu")
    )
    path = os.path.join(base, subdir) if subdir else base
    os.makedirs(path, exist_ok=True)
    return path


def file_sha256(path: str, chunk_size: int = 1 << 20) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            digest.update(chunk)
    return digest.hexdigest()


def file_is_downloaded(
    path: str,
    expected_sha256: Optional[str] = None,
    expected_size: Optional[int] = None,
) -> bool:
    """True when the file exists and passes whichever integrity checks are known."""
    if not os.path.exists(path):
        return False
    if expected_size is not None and os.path.getsize(path) != expected_size:
        return False
    if expected_sha256 is not None and file_sha256(path) != expected_sha256:
        return False
    return True


def check_download_file(
    url: str,
    dest_path: Optional[str] = None,
    expected_sha256: Optional[str] = None,
    timeout: float = 60.0,
) -> str:
    """
    Download ``url`` to ``dest_path`` (default: the cache's ``downloads``)
    unless it is there and valid; returns the path. Sends ``HF_TOKEN`` as a
    bearer token to huggingface.co. Raises on any failure.
    """
    if dest_path is None:
        dest_path = os.path.join(get_cache_dir("downloads"), os.path.basename(url.split("?")[0]))
    if os.path.exists(dest_path) and (
        expected_sha256 is None or file_sha256(dest_path) == expected_sha256
    ):
        return dest_path
    if os.environ.get("HEYBUDDY_OFFLINE"):
        raise ConnectionError(f"HEYBUDDY_OFFLINE is set; not downloading {url}")

    request = urllib.request.Request(url)
    token = os.environ.get("HF_TOKEN")
    if token and "huggingface.co" in url:
        request.add_header("Authorization", f"Bearer {token}")
    tmp_path = dest_path + ".part"
    logger.info(f"Downloading {url} -> {dest_path}")
    with urllib.request.urlopen(request, timeout=timeout) as response, open(tmp_path, "wb") as out:
        shutil.copyfileobj(response, out)
    if expected_sha256 is not None:
        actual = file_sha256(tmp_path)
        if actual != expected_sha256:
            os.remove(tmp_path)
            raise IOError(f"SHA256 mismatch for {url}: expected {expected_sha256}, got {actual}")
    os.replace(tmp_path, dest_path)
    return dest_path
