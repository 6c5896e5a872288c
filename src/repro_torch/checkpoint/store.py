"""Read path of the checkpoint tensor store (msgpack manifest + zlib payload).

Layout, as the JAX package writes it:

  <dir>/step_<n>/manifest.msgpack   tree structure + tensor metadata
                                    (+ "compression" format tag)
  <dir>/step_<n>/data.bin.zst       concatenated tensor payloads
  <dir>/LATEST                      pointer (text, step number)

The port needs neither ``msgpack`` nor ``zstandard``: the manifest is
read by a small msgpack decoder covering what manifests hold (maps,
arrays, str, bin, ints, floats, bools, nil) and a zlib payload by the
standard library. A zstd-tagged payload raises a clear error. The
write path comes with training (ROADMAP slice 6).
"""

from __future__ import annotations

import os
import pathlib
import struct
import zlib
from typing import Any

import numpy as np

from repro_torch import convert

_KEY_SEP = "/"


class _Reader:
    """Minimal msgpack decoder over one bytes buffer."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int) -> str:
        return self._take(n).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: (">B", self._take), 0xC5: (">H", self._take),
            0xC6: (">I", self._take),
            0xD9: (">B", self._str), 0xDA: (">H", self._str),
            0xDB: (">I", self._str),
            0xDC: (">H", self._array), 0xDD: (">I", self._array),
            0xDE: (">H", self._map), 0xDF: (">I", self._map),
        }
        if t in sized:
            fmt, read = sized[t]
            return read(self._unpack(fmt))
        scalars = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if t in scalars:
            return self._unpack(scalars[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (the subset checkpoint manifests use)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _decompress(blob: bytes, compression: str, max_output_size: int):
    if compression == "zstd":
        raise ValueError(
            "checkpoint payload is zstd-compressed; this reader takes zlib "
            "payloads only (re-write the checkpoint with the zlib codec)"
        )
    if compression == "zlib":
        d = zlib.decompressobj()
        out = d.decompress(blob, max_output_size)
        if d.unconsumed_tail:
            raise ValueError(
                "zlib checkpoint payload exceeds the manifest's declared "
                f"size ({max_output_size} bytes)"
            )
        return out
    raise ValueError(f"unknown compression '{compression}'")


def latest_step(directory: str | os.PathLike) -> int | None:
    f = pathlib.Path(directory) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def read_arrays(
    directory: str | os.PathLike, *, step: int | None = None
) -> dict[str, Any]:
    """The checkpoint's tensors as a nested dict of numpy arrays.

    Names split on "/" into the nesting (``bn/s0b0/bn1/mean``).
    """
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {directory}")
    d = directory / f"step_{step:08d}"
    meta = unpackb((d / "manifest.msgpack").read_bytes())
    blob = _decompress(
        (d / "data.bin.zst").read_bytes(),
        meta.get("compression", "zstd"),  # untagged checkpoints are zstd
        max_output_size=sum(t["nbytes"] for t in meta["tensors"]) or 1,
    )
    tree: dict[str, Any] = {}
    for t in meta["tensors"]:
        n = int(np.prod(t["shape"])) if t["shape"] else 1
        arr = np.frombuffer(
            blob, dtype=np.dtype(t["dtype"]), count=n, offset=t["offset"],
        ).reshape(t["shape"])
        *path, leaf = t["name"].split(_KEY_SEP)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def restore(
    directory: str | os.PathLike,
    *,
    step: int | None = None,
    device: str | Any = "cuda",
) -> dict[str, Any]:
    """Restore a checkpoint as a nested dict of tensors on ``device``."""
    return convert.to_torch(read_arrays(directory, step=step), device=device)
