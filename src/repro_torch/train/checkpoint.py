"""Msgpack checkpoints in the reference's format, byte for byte: the
port's counterpart of `repro.train.checkpoint`.

The file is one msgpack map ``{"tree": …, "step": int}`` (``step`` only
when given). In the tree an array is ``{"__arr__": True, "dtype": name,
"shape": [...], "data": raw bytes}``, a list or tuple is ``{"__list__":
[...], "__tuple__": bool}``, a dict keeps its keys in sorted order (as
``jax.device_get`` leaves them in the reference) and a scalar (int,
float, bool, str, None) is itself. bfloat16 tensors are written through
an int16 view under the dtype name ``bfloat16``, ml_dtypes' name, so the
reference reads them back as bfloat16. Files written here load in the
reference and the reference's files load here.

The msgpack codec is the port's own, a small pure-Python one for the
subset the format uses, with msgpack-python's ``packb(use_bin_type=True)``
choices: the smallest encoding of each int, str8/bin8 and up, float64
for floats. Array bytes stream straight from the tensor to the file and
back, so a checkpoint of several GB is never copied whole in memory.
``load_checkpoint(shardings=)`` restores onto a mesh: each leaf becomes
a DTensor of its (mesh, placements), as the reference's
``jax.device_put`` places it.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Callable

import numpy as np
import torch

from repro_torch._device import resolve_device

Tree = Any

_ARR = "__arr__"
_SCALARS = (int, float, bool, str, type(None))
_DTYPES = {torch.float64: "float64", torch.float32: "float32",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
           torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_BY_NAME = {name: dt for dt, name in _DTYPES.items()}


# ------------------------------------------------------------------ encode
def _host_array(t) -> tuple[str, list, np.ndarray]:
    """(dtype name, shape, C-contiguous numpy array of the bytes) of a
    tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        if hasattr(t, "full_tensor"):         # a DTensor: the whole array
            t = t.full_tensor()
        t = t.detach().to("cpu").contiguous()
        name = _DTYPES.get(t.dtype)
        if name is None:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy()
        return name, list(t.shape), arr
    arr = np.ascontiguousarray(t)
    return str(arr.dtype), list(arr.shape), arr


def _encode(node):
    """The reference's encoding of a tree, dict keys sorted; an array's
    ``data`` stays a numpy array until it is written."""
    if isinstance(node, (torch.Tensor, np.ndarray)):
        name, shape, arr = _host_array(node)
        return {_ARR: True, "dtype": name, "shape": shape, "data": arr}
    if isinstance(node, dict):
        return {key: _encode(node[key]) for key in sorted(node)}
    if isinstance(node, (list, tuple)):
        return {"__list__": [_encode(v) for v in node],
                "__tuple__": isinstance(node, tuple)}
    if isinstance(node, _SCALARS):
        return node
    raise TypeError(f"cannot checkpoint {type(node)}")


def _sized(write: Callable, n: int, small: int | None, small_max: int,
           codes: tuple) -> None:
    """A length header: ``small | n`` in one byte when n < small_max
    (``small`` None: no fix form), else the 8/16/32-bit form of
    ``codes`` (None where the kind has no such form)."""
    if small is not None and n < small_max:
        write(bytes((small | n,)))
    elif codes[0] is not None and n < 1 << 8:
        write(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        write(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        write(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack_int(write: Callable, n: int) -> None:
    if 0 <= n < 128:
        write(bytes((n,)))
    elif -32 <= n < 0:
        write(bytes((n & 0xff,)))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if n < top:
                write(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"msgpack: int {n} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">Bb", -(1 << 7)),
                               (0xd1, ">Bh", -(1 << 15)),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if n >= low:
                write(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"msgpack: int {n} does not fit 64 bits")


def _pack(write: Callable, obj) -> None:
    """msgpack of obj onto ``write``, as ``msgpack.packb(obj,
    use_bin_type=True)`` gives it."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(write, obj)
    elif isinstance(obj, float):
        write(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(write, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        write(data)
    elif isinstance(obj, (bytes, bytearray, np.ndarray)):
        data = obj.reshape(-1).view(np.uint8) \
            if isinstance(obj, np.ndarray) else obj
        _sized(write, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        write(memoryview(data))
    elif isinstance(obj, (list, tuple)):
        _sized(write, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for item in obj:
            _pack(write, item)
    elif isinstance(obj, dict):
        _sized(write, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for key, value in obj.items():
            _pack(write, key)
            _pack(write, value)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj)}")


def save_checkpoint(path: str, tree: Tree, step: int | None = None) -> str:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numpy
    arrays and scalars) and ``step`` to ``path`` atomically: the bytes go
    to ``path + ".tmp"``, which then replaces ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"tree": _encode(tree)}
    if step is not None:
        payload["step"] = int(step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _pack(f.write, payload)
    os.replace(tmp, path)
    return path


# ------------------------------------------------------------------ decode
class _Reader:
    """msgpack decoder over one buffer; ``bin`` payloads come back as
    memoryviews into it (no copy)."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
              0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
              0xca: ">f", 0xcb: ">d"}
    _LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
            0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated checkpoint")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self):
        code = self._take(1)[0]
        if code < 0x80:
            return code
        if code >= 0xe0:
            return code - 0x100
        if code < 0x90:
            return self._map(code & 0x0f)
        if code < 0xa0:
            return self._array(code & 0x0f)
        if code < 0xc0:
            return str(self._take(code & 0x1f), "utf-8")
        if code in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[code]
        if code in self._FIXED:
            return self._unpack(self._FIXED[code])
        if code in self._LEN:
            n = self._unpack(self._LEN[code])
            if code <= 0xc6:
                return self._take(n)
            if code <= 0xdb:
                return str(self._take(n), "utf-8")
            return self._array(n) if code <= 0xdd else self._map(n)
        raise ValueError(f"msgpack: type byte {code:#04x} is not in the "
                         f"checkpoint format")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _decode(node, device: torch.device):
    if isinstance(node, dict):
        if node.get(_ARR):
            name = node["dtype"]
            host = np.dtype("int16") if name == "bfloat16" else np.dtype(name)
            # a copy: aligned, and not holding the whole file's buffer
            arr = np.frombuffer(node["data"], dtype=host).copy()
            t = torch.from_numpy(arr.reshape(node["shape"]))
            if name == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(device)
        if "__list__" in node:
            items = [_decode(v, device) for v in node["__list__"]]
            return tuple(items) if node.get("__tuple__") else items
        return {key: _decode(value, device) for key, value in node.items()}
    return node


def load_checkpoint(path: str, *, shardings: Tree | None = None,
                    device=None) -> tuple[Tree, int | None]:
    """The tree and step of a checkpoint (the port's or the
    reference's), arrays as tensors on ``device`` (the card unless the
    caller names another). With ``shardings`` (a tree of (mesh,
    placements) over the checkpoint's tree, or a subtree of it;
    `repro_torch.launch.sharding.make_shardings`) each array leaf it
    covers is distributed as a DTensor of that layout; a None leaf stays
    a plain tensor."""
    tree, step = _load(path, resolve_device(device))
    if shardings is not None:
        tree = _distribute_over(tree, shardings)
    return tree, step


def _distribute_over(tree: Tree, shardings: Tree) -> Tree:
    from repro_torch.launch.sharding import distribute

    if isinstance(tree, dict) and isinstance(shardings, dict):
        return {key: (_distribute_over(value, shardings[key])
                      if key in shardings else value)
                for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        return distribute(tree, shardings)
    return tree


def _load(path: str, device: torch.device) -> tuple[Tree, int | None]:
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    reader = _Reader(memoryview(buf))
    payload = reader.read()
    if reader.pos != len(buf) or not isinstance(payload, dict) \
            or "tree" not in payload:
        raise ValueError(f"{path} is not a checkpoint")
    return _decode(payload["tree"], device), payload.get("step")
