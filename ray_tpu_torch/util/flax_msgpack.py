"""flax's msgpack checkpoint layout, without the ``msgpack`` package.

``flax.serialization.to_bytes``/``msgpack_restore`` write and read a
state dict: maps with string keys (a list or tuple is a map of "0",
"1", ...), Python scalars, and arrays as msgpack extension types: code
1 packs ``(shape, dtype name, C-order bytes)`` of an ndarray, code 3 a
numpy scalar the same way, code 2 a complex.  An array above 1 GiB is
split into a ``__msgpack_chunked_array__`` map of flat chunks.  This
module encodes and decodes exactly that subset, byte for byte as
msgpack-python packs it (smallest integer and length forms, float64,
``use_bin_type``), so the files are interchangeable with the JAX
package's ``Checkpoint.save_pytree``/``load_pytree``.

``bfloat16``, which numpy lacks, travels by name: a ``torch.bfloat16``
tensor is written with the dtype name ``bfloat16`` (flax's name for
``jnp.bfloat16``), and such an array is read back as a CPU
``torch.bfloat16`` tensor.  Every other array is read as numpy.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30
_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3


# ------------------------------------------------------------ encoding
def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], codes):
    """Append a length header: ``fix`` (base, limit) for the fix form,
    then (code, struct format, limit) triples."""
    base, limit = fix
    if limit and n < limit:
        out.append(base | n)
        return
    for code, fmt, lim in codes:
        if n <= lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out += struct.pack(">b", x)
    elif x >= 0:
        for code, fmt, lim in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if x <= lim:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} too large for msgpack")
    else:
        for code, fmt, lim in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if x >= lim:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} too small for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, (0, 0), ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                                   (0xc9, ">I", 0xffffffff)))
    out += struct.pack(">b", code)
    out += data


def _array_parts(x) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of an array or tensor."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    x.view(torch.int16).numpy().tobytes())
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return x.shape, x.dtype.name, x.tobytes("C")


def _pack(out: bytearray, x: Any) -> None:
    import torch

    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), (0xa0, 32),
                  ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                   (0xdb, ">I", 0xffffffff)))
        out += data
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), (0, 0),
                  ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                   (0xc6, ">I", 0xffffffff)))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), (0x90, 16),
                  ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff)))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), (0x80, 16),
                  ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff)))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _NDARRAY, packb(_array_parts(x)))
    elif isinstance(x, np.generic):
        _pack_ext(out, _NPSCALAR, packb(_array_parts(np.asarray(x))))
    elif type(x) is complex:
        _pack_ext(out, _COMPLEX, packb((x.real, x.imag)))
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def packb(x: Any) -> bytes:
    out = bytearray()
    _pack(out, x)
    return bytes(out)


def _itemsize(x) -> int:
    return x.element_size() if hasattr(x, "element_size") \
        else x.dtype.itemsize


def _numel(x) -> int:
    return x.numel() if hasattr(x, "numel") else x.size


def _chunk(x) -> Dict[str, Any]:
    """flax's canonical map of an array's flat chunks."""
    step = max(1, MAX_CHUNK_SIZE // _itemsize(x))
    flat = x.reshape(-1)
    chunks = [flat[i:i + step] for i in range(0, _numel(x), step)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def to_state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of nested dicts, lists and tuples:
    string keys, sequences as maps of their indices, big arrays
    chunked."""
    import torch

    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and \
            _numel(tree) * _itemsize(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of the tree."""
    return packb(to_state_dict(tree))


# ------------------------------------------------------------ decoding
class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b & 0xf0 == 0x80:
            return self._map(b & 0x0f)
        if b & 0xf0 == 0x90:
            return [self.read() for _ in range(b & 0x0f)]
        if b & 0xe0 == 0xa0:
            return self._str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in lens:
            return self._str(self.unpack(lens[b]))
        bins = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in bins:
            return self.take(self.unpack(bins[b]))
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self._map(self.unpack(">H" if b == 0xde else ">I"))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        exts = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in exts:
            return self._ext(self.unpack(exts[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _NPSCALAR:
            arr = _ndarray_from_bytes(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == _COMPLEX:
            real, imag = unpackb(data)
            return complex(real, imag)
        raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the msgpack object")
    return out


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        import torch

        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if chunks and not isinstance(chunks[0], np.ndarray):
            import torch

            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict, arrays
    as numpy (bfloat16 as a CPU torch tensor)."""
    return _unchunk(unpackb(data))
