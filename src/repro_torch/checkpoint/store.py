"""Checkpoint tensor store: msgpack manifest + zlib payload, atomic
publish, async writes, restore into a target tree.

Layout, the JAX package's:

  <dir>/step_<n>/manifest.msgpack   tree structure + tensor metadata
                                    (+ "compression" format tag)
  <dir>/step_<n>/data.bin.zst       concatenated tensor payloads
  <dir>/LATEST                      atomic pointer (text, step number)

The port needs neither ``msgpack``, ``zstandard`` nor ``ml_dtypes``:
manifests are written and read by a small msgpack codec covering what
they hold (maps, arrays, str, bin, ints, floats, bools, nil), payloads
are zlib streams of stored blocks (tagged "zlib" in the manifest, which
the JAX package reads), and bfloat16 / float8_e4m3fn tensors travel as the bits of their integer
view. A zstd-tagged payload raises a clear error.

Tensor names are the JAX package's leaf paths: dict keys, NamedTuple
and dataclass fields, sequence indices, joined by "/"; ``None`` and the
dataclass fields marked ``metadata={"static": True}`` (a plan's
``weight_bits``, a conv's ``kernel_hw``) are structure, not leaves.
Python scalars are leaves (saved as ``np.asarray`` saves them). So a
checkpoint of a port tree restores into the same tree of the JAX package
and back.

Publishing: the payload and manifest go to ``.tmp_step_<n>``, are
fsynced, the directory is renamed to ``step_<n>``, then ``LATEST`` is
flipped by an atomic rename: a crash mid-write never corrupts the
restore point.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import shutil
import struct
import threading
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.convert import VIEW_DTYPES

_KEY_SEP = "/"
_COMPRESSION = "zlib"
# Stored deflate blocks (level 0): float32 weights shrink by only about 7%
# at zlib level 3, which writes about 17 MB/s on one CPU core; stored
# blocks write about 340 MB/s. Any zlib reader takes either.
_ZLIB_LEVEL = 0

# Dtype names numpy cannot resolve without ml_dtypes: their bits are read
# and written through an integer view of the same width.
_TORCH_VIEW = {dt: (np_int, name)
               for name, (np_int, dt) in VIEW_DTYPES.items()}


# ---------------------------------------------------------------------------
# msgpack codec (the subset manifests use)
# ---------------------------------------------------------------------------


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


def _sized(n: int, fix: tuple[int, int] | None, tags: tuple[int, ...]
           ) -> bytes:
    """The header of a str/bin/array/map of length n: the fix form
    (base, limit) when it fits, else the 8/16/32-bit length form."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for tag, fmt in zip(tags, (">B", ">H", ">I")[-len(tags):]):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
        if v >= 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                        (0xD3, ">q"))
    for tag, fmt in forms:
        try:
            return bytes([tag]) + struct.pack(fmt, v)
        except struct.error:
            continue
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj)`` does with its defaults
    (bin type on, doubles, the smallest integer form): dicts, lists and
    tuples, str, bytes, ints, floats, bools and None."""
    out = bytearray()

    def put(v):
        if v is None:
            out.append(0xC0)
        elif v is True or v is False:
            out.append(0xC3 if v else 0xC2)
        elif isinstance(v, int):
            out.extend(_int(v))
        elif isinstance(v, float):
            out.extend(b"\xcb" + struct.pack(">d", v))
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            out.extend(_sized(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)))
            out.extend(raw)
        elif isinstance(v, (bytes, bytearray)):
            out.extend(_sized(len(v), None, (0xC4, 0xC5, 0xC6)))
            out.extend(v)
        elif isinstance(v, (list, tuple)):
            out.extend(_sized(len(v), (0x90, 16), (0xDC, 0xDD)))
            for x in v:
                put(x)
        elif isinstance(v, dict):
            out.extend(_sized(len(v), (0x80, 16), (0xDE, 0xDF)))
            for k, x in v.items():
                put(k)
                put(x)
        else:
            raise TypeError(f"cannot msgpack {type(v).__name__}")

    put(obj)
    return bytes(out)


# ---------------------------------------------------------------------------
# Tree paths
# ---------------------------------------------------------------------------


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _data_fields(node) -> list[str]:
    return [f.name for f in dataclasses.fields(node)
            if not f.metadata.get("static")]


def _children(node) -> list[tuple[str, Any]] | None:
    """(path part, child) of a container in the JAX package's flattening
    order (dict keys sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f, getattr(node, f)) for f in _data_fields(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaves_with_names(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf, in the JAX package's order and names."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for part, child in kids:
        out += leaves_with_names(
            child, f"{prefix}{_KEY_SEP}{part}" if prefix else part)
    return out


def map_with_names(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """The tree with each leaf replaced by ``fn(name, leaf)``; containers
    keep their types (and a dataclass its static fields)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    mapped = {part: map_with_names(
        fn, child, f"{prefix}{_KEY_SEP}{part}" if prefix else part)
        for part, child in kids}
    if isinstance(tree, dict):
        return {k: mapped[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(mapped[f] for f in tree._fields))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **mapped)
    return type(tree)(mapped[str(i)] for i in range(len(tree)))


# ---------------------------------------------------------------------------
# Write path
# ---------------------------------------------------------------------------


def _host_array(leaf: Any) -> tuple[np.ndarray, str]:
    """(a numpy array holding the leaf's bytes, its dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _TORCH_VIEW:
            np_int, name = _TORCH_VIEW[t.dtype]
            return t.view(getattr(torch, np.dtype(np_int).name)).numpy(), name
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree: Any) -> Any:
    """A host copy of every tensor leaf: later in-place updates of the
    live tree (or a tensor that is already on the host) cannot reach it."""
    def copy(_, leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return leaf
    return map_with_names(copy, tree)


def save(tree: Any, directory: str | os.PathLike, step: int) -> str:
    """Synchronous checkpoint write with atomic publish."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    tmp.mkdir(parents=True, exist_ok=True)

    manifest = []
    offset = 0
    comp = zlib.compressobj(_ZLIB_LEVEL)
    # The file name is the JAX package's; the "compression" tag decides.
    with open(tmp / "data.bin.zst", "wb") as f:
        for name, leaf in leaves_with_names(tree):
            arr, dtype = _host_array(leaf)
            raw = np.ascontiguousarray(arr)
            f.write(comp.compress(raw.reshape(-1).view(np.uint8)))
            manifest.append({"name": name, "dtype": dtype,
                             "shape": list(arr.shape), "offset": offset,
                             "nbytes": raw.nbytes})
            offset += raw.nbytes
        f.write(comp.flush())
        f.flush()
        os.fsync(f.fileno())
    with open(tmp / "manifest.msgpack", "wb") as f:
        f.write(packb({"step": step, "compression": _COMPRESSION,
                       "tensors": manifest}))
        f.flush()
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    latest_tmp = directory / ".LATEST.tmp"
    latest_tmp.write_text(str(step))
    latest_tmp.rename(directory / "LATEST")
    return str(final)


class AsyncCheckpointer:
    """Snapshot to the host, then write in a daemon thread.

    ``save`` blocks for the device-to-host copy only (and for a write
    still outstanding: one at a time); a write's error is raised by the
    next ``wait``.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, tree: Any, directory: str | os.PathLike, step: int):
        self.wait()
        host_tree = _snapshot(tree)

        def work():
            try:
                save(host_tree, directory, step)
            except BaseException as e:  # noqa: BLE001 - raised in wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# ---------------------------------------------------------------------------
# Read path
# ---------------------------------------------------------------------------


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


def _resolve_step(directory: pathlib.Path, step: int | None) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {directory}")
    return step


def read_tensors(
    directory: str | os.PathLike, *, step: int | None = None
) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint by name, as host tensors (bfloat16 and
    float8_e4m3fn ones carried over bit for bit through their integer
    view)."""
    directory = pathlib.Path(directory)
    d = directory / f"step_{_resolve_step(directory, step):08d}"
    meta = unpackb((d / "manifest.msgpack").read_bytes())
    blob = _decompress(
        (d / "data.bin.zst").read_bytes(),
        meta.get("compression", "zstd"),  # untagged checkpoints are zstd
        max_output_size=sum(t["nbytes"] for t in meta["tensors"]) or 1,
    )
    out = {}
    for t in meta["tensors"]:
        n = int(np.prod(t["shape"])) if t["shape"] else 1
        as_int, view = VIEW_DTYPES.get(t["dtype"], (t["dtype"], None))
        # count is explicit: trees mix dtypes, so offsets are not aligned
        # to every element size.
        arr = np.frombuffer(blob, dtype=np.dtype(as_int), count=n,
                            offset=t["offset"]).reshape(t["shape"]).copy()
        ten = torch.from_numpy(arr)
        out[t["name"]] = ten.view(view) if view is not None else ten
    return out


def restore(
    directory: str | os.PathLike,
    target: Any = None,
    *,
    step: int | None = None,
    device: str | torch.device | None = None,
) -> Any:
    """Restore a checkpoint (the latest, or ``step``).

    Without ``target``: every tensor as a nested dict (names split on
    "/") on ``device`` (default "cuda").

    With ``target`` (a tree of tensors, meta tensors or Python scalars):
    the same tree filled from the checkpoint by leaf name, each tensor
    cast to its target leaf's dtype and put on ``device``, else on the
    target leaf's device (the host for a Python scalar). A name missing
    from the checkpoint raises KeyError, a shape that differs ValueError.
    """
    tensors = read_tensors(directory, step=step)
    if target is None:
        tree: dict[str, Any] = {}
        dev = "cuda" if device is None else device
        for name, t in tensors.items():
            *path, leaf = name.split(_KEY_SEP)
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = t.to(dev)
        return tree

    def fill(name, leaf):
        if name not in tensors:
            raise KeyError(f"checkpoint missing tensor '{name}'")
        t = tensors[name]
        want = tuple(getattr(leaf, "shape", ()))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} "
                             f"!= target {want}")
        if isinstance(leaf, torch.Tensor):
            t = t.to(leaf.dtype)
            dev = leaf.device if device is None else device
        else:
            dev = "cpu" if device is None else device
        return t.to(dev)

    return map_with_names(fill, target)
