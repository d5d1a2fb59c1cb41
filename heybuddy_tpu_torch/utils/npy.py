"""
Appendable ``.npy`` files.

Counterpart of the JAX package's ``utils/npy.py``: a standard ``.npy`` file
whose header is padded so the shape field can be rewritten in place as rows
are appended. The files are plain ``.npy``, readable by
``np.load(..., mmap_mode="r")``, and byte for byte the JAX package's for the
same appends.
"""

from __future__ import annotations

import ast
import os
import struct
from typing import Any, Optional, Tuple

import numpy as np

__all__ = ["AppendableNpyFile", "read_npy_header", "ensure_appendable"]

_MAGIC = b"\x93NUMPY"
# Enough header padding to describe any shape a shard grows to.
_HEADER_PAD = 128


def _header_dict(dtype: np.dtype, shape: Tuple[int, ...]) -> str:
    descr = np.lib.format.dtype_to_descr(dtype)
    return "{'descr': %r, 'fortran_order': False, 'shape': %r, }" % (descr, shape)


def _build_header(dtype: np.dtype, shape: Tuple[int, ...]) -> bytes:
    """Serialize a v1.0 npy header, padded to a fixed total size for in-place growth."""
    dict_str = _header_dict(dtype, shape)
    base_len = len(_MAGIC) + 2 + 2  # magic + version + header-length field
    total = base_len + len(dict_str) + 1  # +1 newline terminator
    # round up to 64 and add fixed pad so shape growth never overflows the header
    padded = ((total + _HEADER_PAD + 63) // 64) * 64
    header = dict_str + " " * (padded - base_len - len(dict_str) - 1) + "\n"
    out = _MAGIC + bytes([1, 0]) + struct.pack("<H", len(header)) + header.encode("latin1")
    assert len(out) == padded
    return out


def _rewrite_header(f: Any, dtype: np.dtype, shape: Tuple[int, ...], data_offset: int) -> None:
    """Rewrite the v1.0 header of an open file in place, keeping its length."""
    dict_str = _header_dict(dtype, shape)
    header_len = data_offset - 10
    if len(dict_str) + 1 > header_len:
        raise OverflowError("Header padding exhausted; shape string too long")
    header = dict_str + " " * (header_len - len(dict_str) - 1) + "\n"
    f.seek(0)
    f.write(_MAGIC + bytes([1, 0]) + struct.pack("<H", header_len) + header.encode("latin1"))


def read_npy_header(path: str) -> Tuple[np.dtype, Tuple[int, ...], int]:
    """Return (dtype, shape, data_offset) for a .npy file."""
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != _MAGIC:
            raise ValueError(f"{path} is not a .npy file")
        major, _minor = f.read(2)
        if major == 1:
            (header_len,) = struct.unpack("<H", f.read(2))
            offset = 10 + header_len
        else:
            (header_len,) = struct.unpack("<I", f.read(4))
            offset = 12 + header_len
        header = f.read(header_len).decode("latin1")
    info = ast.literal_eval(header)
    dtype = np.lib.format.descr_to_dtype(info["descr"])
    return dtype, tuple(info["shape"]), offset


class AppendableNpyFile:
    """
    A ``.npy`` file that supports appending rows along axis 0 in place.

    The file stays a valid ``.npy`` after every append (header rewritten in
    place), so readers can memory-map it at any time. If a process died
    mid-write, :func:`ensure_appendable` (run on open) truncates to the last
    whole row and fixes the header.
    """

    def __init__(self, path: str) -> None:
        self.path = os.path.abspath(path)
        self._dtype: Optional[np.dtype] = None
        self._shape: Optional[Tuple[int, ...]] = None
        self._data_offset: Optional[int] = None
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            ensure_appendable(self.path)
            self._dtype, self._shape, self._data_offset = read_npy_header(self.path)

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return self._shape

    @property
    def dtype(self) -> Optional[np.dtype]:
        return self._dtype

    def __len__(self) -> int:
        return 0 if self._shape is None else self._shape[0]

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows)
        if self._shape is None:
            # First write: create the file with a padded header.
            header = _build_header(rows.dtype, rows.shape)
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.path, "wb") as f:
                f.write(header)
                rows.tofile(f)
            self._dtype = rows.dtype
            self._shape = rows.shape
            self._data_offset = len(header)
            return

        if rows.dtype != self._dtype:
            raise TypeError(f"dtype mismatch: file={self._dtype}, rows={rows.dtype}")
        if rows.shape[1:] != self._shape[1:]:
            raise ValueError(f"row shape mismatch: file={self._shape[1:]}, rows={rows.shape[1:]}")

        new_shape = (self._shape[0] + rows.shape[0],) + self._shape[1:]
        with open(self.path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            rows.tofile(f)
            _rewrite_header(f, self._dtype, new_shape, self._data_offset)
        self._shape = new_shape

    def read(self, mmap: bool = True) -> np.ndarray:
        return np.load(self.path, mmap_mode="r" if mmap else None)

    def __enter__(self) -> "AppendableNpyFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


def ensure_appendable(path: str) -> None:
    """
    Repair a possibly truncated appendable .npy: if the data section does not
    cover a whole number of rows (an interrupted append), truncate to the last
    complete row and rewrite the header shape.
    """
    dtype, shape, offset = read_npy_header(path)
    if not shape:
        return
    row_bytes = dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
    actual_data = os.path.getsize(path) - offset
    actual_rows = actual_data // row_bytes if row_bytes else 0
    if actual_rows == shape[0] and actual_data == shape[0] * row_bytes:
        return
    with open(path, "r+b") as f:
        f.truncate(offset + actual_rows * row_bytes)
        _rewrite_header(f, dtype, (int(actual_rows),) + shape[1:], offset)
