"""The FlexBuffers subset that ``.gcloud`` / ``.gc4d`` files use: a root map
of columns, each an untyped vector of row maps whose values are typed
vectors or scalars (src/io/gcloud/flexbuffers.rs:10-37).

The port carries its own codec: it may import neither the ``flatbuffers``
package nor the JAX package's C++ module, whose layout
(``native/gsplat_native.cpp:283-812``) the writer follows byte for byte:
every offset, size and scalar 4 bytes wide, each column's rows sharing one
key vector, every row of a column one fixed stride.  So one column is one
numpy array of 32-bit words, laid out with its offsets computed at once.

The reader has two paths.  :func:`read_columns_vectorised` takes files in
that layout (this writer's and the C++ encoder's): it reads the root map
and the column vectors, then every row's offsets, sizes and payloads as
numpy gathers, and checks that each row has the layout of the first.
:func:`read_columns_general` reads any conforming FlexBuffer element by
element, widths per vector (8, 16, 32 or 64 bits), inline and indirect
scalars, typed, fixed-length and untyped vectors: the layouts that the
``flatbuffers`` package's ``Builder`` writes.  :func:`read_columns` takes
the vectorised path where the layout allows and the general one elsewhere,
and counts which it took in ``read_columns.paths``.

A column is read by a spec ``(name, fields)``: ``fields`` is a list of
``(key, dim, dtype)``, with ``dim`` 0 for a scalar, a length for a vector,
or ``None`` for a vector whose length comes from the data (the same in
every row).  Its fields are concatenated in the spec's order into one
``[N, C]`` array of ``dtype`` (float32 or uint32).
"""

from __future__ import annotations

import struct

import numpy as np

# value types (flexbuffers.h)
INT, UINT, FLOAT = 1, 2, 3
INDIRECT_INT, INDIRECT_UINT, INDIRECT_FLOAT = 6, 7, 8
MAP, VECTOR = 9, 10
VECTOR_INT, VECTOR_UINT, VECTOR_FLOAT = 11, 12, 13
VECTOR_STRING_DEPRECATED = 15  # the last typed vector with a size (14 holds keys)
VECTOR_INT2, VECTOR_FLOAT4 = 16, 24  # the fixed-length typed vectors, 2 to 4 long
BOOL, VECTOR_BOOL = 26, 36
W32 = 2  # bit width code of a 4-byte value

_INLINE = (INT, UINT, FLOAT, BOOL)
_INDIRECT = {INDIRECT_INT: INT, INDIRECT_UINT: UINT, INDIRECT_FLOAT: FLOAT}
_NUMPY = {INT: "<i", UINT: "<u", FLOAT: "<f", BOOL: "<u"}
_FLOAT_FORMATS = {2: "<e", 4: "<f", 8: "<d"}


def packed_type(value_type: int, width_code: int = W32) -> int:
    return value_type << 2 | width_code


class _Fallback(Exception):
    """The file's layout is not the fixed-stride one: read it generally."""


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _align4(pos: int) -> bytes:
    return b"\0" * (-pos % 4)


def _words(values) -> bytes:
    words = np.asarray(values, np.int64)
    if words.size and (words.min() < 0 or words.max() >= 1 << 32):
        raise ValueError("a FlexBuffer offset does not fit in 32 bits: the cloud is too large for the file")
    return words.astype("<u4").tobytes()


def _type_words(types: list) -> np.ndarray:
    """Packed type bytes, zero-padded to whole 32-bit words."""
    raw = bytes(types) + _align4(len(types))
    return np.frombuffer(raw, "<u4")


def _column(pos: int, key_pos: dict, fields: list) -> tuple:
    """One column at ``pos``: its key vector, its rows (the vectors' payloads
    in key order, then the row map) and its vector of row offsets.  Returns
    (bytes, the column vector's location)."""
    out = [_align4(pos)]
    pos += len(out[0])
    fields = sorted(fields, key=lambda f: f[0])
    k = len(fields)
    n = len(fields[0][1])
    kv_loc = pos + 4
    out.append(_words([k] + [kv_loc + 4 * i - key_pos[key] for i, (key, _) in enumerate(fields)]))
    pos = kv_loc + 4 * k

    vec_word, w = {}, 0
    for key, arr in fields:
        if arr.ndim == 2:
            vec_word[key] = w + 1
            w += 1 + arr.shape[1]
    map_word = w + 3
    type_words = _type_words([
        packed_type((VECTOR_FLOAT if arr.dtype == np.float32 else VECTOR_UINT) if arr.ndim == 2
                    else (FLOAT if arr.dtype == np.float32 else UINT))
        for _, arr in fields
    ])
    stride = map_word + k + len(type_words)
    rows = np.zeros((n, stride), "<u4")
    for key, arr in fields:
        if arr.ndim == 2:
            rows[:, vec_word[key] - 1] = arr.shape[1]
            rows[:, vec_word[key]:vec_word[key] + arr.shape[1]] = arr.view("<u4")
    row_base = pos + 4 * stride * np.arange(n, dtype=np.int64)
    rows[:, map_word - 3] = row_base + 4 * (map_word - 3) - kv_loc
    rows[:, map_word - 2] = 4
    rows[:, map_word - 1] = k
    for j, (key, arr) in enumerate(fields):
        slot = map_word + j
        rows[:, slot] = 4 * (slot - vec_word[key]) if arr.ndim == 2 else arr.view("<u4")
    rows[:, map_word + k:] = type_words
    out.append(rows.tobytes())
    pos += rows.nbytes

    col_loc = pos + 4
    if col_loc + 5 * n >= 1 << 32:
        raise ValueError("a FlexBuffer offset does not fit in 32 bits: the cloud is too large for the file")
    map_loc = row_base + 4 * map_word
    out.append(_words(np.concatenate([[n], col_loc + 4 * np.arange(n, dtype=np.int64) - map_loc])))
    out.append(bytes([packed_type(MAP)]) * n)
    return b"".join(out), col_loc


def encode_map(columns: list) -> bytes:
    """A root map of columns -> FlexBuffer bytes.  ``columns`` is a list, in
    the order the bodies are written, of ``(name, [(key, array), ...])``;
    each array is ``[N]`` (a scalar per row) or ``[N, d]`` (a vector per
    row), float32 or uint32, with the same N in a column.  Every key string
    is written once, sorted; maps list their keys sorted."""
    columns = [
        (name, [(key, np.ascontiguousarray(arr, np.float32 if arr.dtype != np.uint32 else np.uint32))
                for key, arr in fields])
        for name, fields in columns
    ]
    keys = sorted({name for name, _ in columns} | {key for _, fields in columns for key, _ in fields})
    key_pos, out, pos = {}, [], 0
    for key in keys:
        key_pos[key] = pos
        out.append(key.encode("utf-8") + b"\0")
        pos += len(out[-1])
    col_loc = {}
    for name, fields in columns:
        body, col_loc[name] = _column(pos, key_pos, fields)
        out.append(body)
        pos += len(body)

    root = sorted(col_loc)
    out.append(_align4(pos))
    pos += len(out[-1])
    kv_loc = pos + 4
    out.append(_words([len(root)] + [kv_loc + 4 * i - key_pos[name] for i, name in enumerate(root)]))
    pos = kv_loc + 4 * len(root)
    map_loc = pos + 12
    out.append(_words([pos - kv_loc, 4, len(root)]
                      + [map_loc + 4 * i - col_loc[name] for i, name in enumerate(root)]))
    out.append(bytes([packed_type(VECTOR)]) * len(root))
    pos = map_loc + 5 * len(root)
    out.append(_align4(pos))
    pos += len(out[-1])
    out.append(_words([pos - map_loc]) + bytes([packed_type(MAP), 4]))
    return b"".join(out)


# ---------------------------------------------------------------------------
# General reader
# ---------------------------------------------------------------------------


class _Ref:
    """A value: where it sits, the byte width of the vector or map holding
    it, and its packed type (value type, and its own byte width)."""

    __slots__ = ("pos", "parent_width", "type", "width")

    def __init__(self, pos: int, parent_width: int, packed: int):
        self.pos, self.parent_width = pos, parent_width
        self.type, self.width = packed >> 2, 1 << (packed & 3)


def _uint(buf: bytes, pos: int, width: int) -> int:
    if pos < 0 or pos + width > len(buf) or width not in (1, 2, 4, 8):
        raise ValueError("malformed FlexBuffer: a read runs outside the data")
    return int.from_bytes(buf[pos:pos + width], "little")


def _check_range(buf: bytes, start: int, length: int) -> None:
    if start < 0 or start + length > len(buf):
        raise ValueError("malformed FlexBuffer: a vector or map runs outside the data")


def _indirect(buf: bytes, pos: int, width: int) -> int:
    return pos - _uint(buf, pos, width)


def _scalar_at(buf: bytes, pos: int, width: int, value_type: int):
    if value_type == FLOAT:
        if width not in _FLOAT_FORMATS or pos < 0 or pos + width > len(buf):
            raise ValueError("malformed FlexBuffer: a float runs outside the data")
        return struct.unpack_from(_FLOAT_FORMATS[width], buf, pos)[0]
    value = _uint(buf, pos, width)
    if value_type == INT and value >= 1 << (8 * width - 1):
        value -= 1 << (8 * width)
    return value


def _root(buf: bytes) -> _Ref:
    if len(buf) < 3:
        raise ValueError("malformed FlexBuffer: too short")
    width = buf[-1]
    return _Ref(len(buf) - 2 - width, width, buf[-2])


def _map_items(buf: bytes, ref: _Ref, key_cache: dict) -> dict:
    if ref.type != MAP:
        raise ValueError(f"malformed FlexBuffer: expected a map, found type {ref.type}")
    loc, width = _indirect(buf, ref.pos, ref.parent_width), ref.width
    n = _uint(buf, loc - width, width)
    keys_loc = _indirect(buf, loc - 3 * width, width)
    keys_width = _uint(buf, loc - 2 * width, width)
    keys = key_cache.get((keys_loc, keys_width, n))
    if keys is None:
        keys = []
        for i in range(n):
            start = _indirect(buf, keys_loc + i * keys_width, keys_width)
            end = buf.find(b"\0", start)
            if start < 0 or end < 0:
                raise ValueError("malformed FlexBuffer: a key runs outside the data")
            keys.append(buf[start:end].decode("utf-8"))
        key_cache[(keys_loc, keys_width, n)] = keys
    _check_range(buf, loc, n * width + n)
    return {key: _Ref(loc + i * width, width, buf[loc + n * width + i]) for i, key in enumerate(keys)}


def _vector(buf: bytes, ref: _Ref) -> tuple:
    """(location, element count, element width, element packed types or one
    packed type for a typed vector)."""
    loc, width = _indirect(buf, ref.pos, ref.parent_width), ref.width
    code = width.bit_length() - 1
    if ref.type == VECTOR:
        n = _uint(buf, loc - width, width)
        _check_range(buf, loc, n * width + n)
        return loc, n, width, [buf[loc + n * width + i] for i in range(n)]
    if VECTOR_INT <= ref.type <= VECTOR_STRING_DEPRECATED or ref.type == VECTOR_BOOL:
        element = BOOL if ref.type == VECTOR_BOOL else ref.type - VECTOR_INT + INT
        return loc, _uint(buf, loc - width, width), width, packed_type(element, code)
    if VECTOR_INT2 <= ref.type <= VECTOR_FLOAT4:
        k = ref.type - VECTOR_INT2
        return loc, k // 3 + 2, width, packed_type(k % 3 + INT, code)
    raise ValueError(f"malformed FlexBuffer: expected a vector, found type {ref.type}")


def _scalar(buf: bytes, ref: _Ref):
    if ref.type in _INLINE:
        return _scalar_at(buf, ref.pos, ref.parent_width, ref.type)
    if ref.type in _INDIRECT:
        return _scalar_at(buf, _indirect(buf, ref.pos, ref.parent_width), ref.width, _INDIRECT[ref.type])
    raise ValueError(f"malformed FlexBuffer: expected a number, found type {ref.type}")


def _vector_values(buf: bytes, ref: _Ref) -> np.ndarray:
    loc, n, width, types = _vector(buf, ref)
    if isinstance(types, int) and types >> 2 in _NUMPY and (types >> 2 != FLOAT or width in _FLOAT_FORMATS):
        _check_range(buf, loc, n * width)
        fmt = _FLOAT_FORMATS[width] if types >> 2 == FLOAT else f"{_NUMPY[types >> 2]}{width}"
        return np.frombuffer(buf, fmt, n, loc)
    if isinstance(types, int):
        types = [types] * n
    return np.asarray([_scalar(buf, _Ref(loc + i * width, width, t)) for i, t in enumerate(types)])


def _root_items(buf: bytes) -> dict:
    return _map_items(buf, _root(buf), {})


def root_keys(data: bytes) -> list:
    """The root map's keys (raises ``ValueError`` on data that is not a
    FlexBuffer map)."""
    return list(_root_items(bytes(data)))


def _column_ref(items: dict, name: str) -> _Ref:
    if name not in items:
        raise ValueError(f"the file has no {name!r} column (it has {sorted(items)})")
    return items[name]


def _field_value(row: dict, key: str, dim, buf: bytes):
    if key not in row:
        raise ValueError(f"a row lacks its {key!r} field")
    if dim == 0:
        return [_scalar(buf, row[key])]
    values = _vector_values(buf, row[key])
    if dim is not None and len(values) != dim:
        raise ValueError(f"field {key!r} holds {len(values)} values, expected {dim}")
    return values


def read_columns_general(data: bytes, spec: list) -> dict:
    """Every column of ``spec`` read element by element (any FlexBuffer
    layout)."""
    buf = bytes(data)
    items = _root_items(buf)
    out = {}
    for name, fields in spec:
        loc, n, width, types = _vector(buf, _column_ref(items, name))
        if isinstance(types, int):
            types = [types] * n
        cache: dict = {}
        rows = [_map_items(buf, _Ref(loc + r * width, width, t), cache) for r, t in enumerate(types)]
        dtype = fields[0][2]
        arr = None
        for r, row in enumerate(rows):
            values = np.concatenate([np.asarray(_field_value(row, key, dim, buf), np.float64 if dtype == np.float32
                                                else np.int64) for key, dim, _ in fields])
            if arr is None:
                arr = np.empty((n, len(values)), dtype)
            elif len(values) != arr.shape[1]:
                raise ValueError(f"column {name!r}: rows of {arr.shape[1]} and {len(values)} values")
            arr[r] = values
        out[name] = arr if arr is not None else np.empty((0, _empty_width(fields)), dtype)
    return out


def _empty_width(fields) -> int:
    # an empty column's vector widths are unknown from the data; None: the
    # degree-3 SH layout
    return sum(1 if dim == 0 else 48 if dim is None else dim for _, dim, _ in fields)


# ---------------------------------------------------------------------------
# Vectorised reader
# ---------------------------------------------------------------------------


def _take(words: np.ndarray, word_index: np.ndarray) -> np.ndarray:
    """The 32-bit words at ``word_index``."""
    if word_index.size and (word_index.min() < 0 or word_index.max() >= len(words)):
        raise _Fallback
    return words[word_index]


def _gather(words: np.ndarray, word_index: np.ndarray) -> np.ndarray:
    """The words at ``word_index`` as int64, to subtract offsets from
    positions."""
    return _take(words, word_index).astype(np.int64)


def _word_index(locs: np.ndarray) -> np.ndarray:
    if locs.size and (locs & 3).any():
        raise _Fallback
    return locs >> 2


def read_columns_vectorised(data: bytes, spec: list) -> dict:
    """Every column of ``spec`` read with numpy gathers, for files in the
    writer's fixed-stride layout; raises ``_Fallback`` on any other."""
    buf = bytes(data)
    items = _root_items(buf)
    words = np.frombuffer(buf, "<u4", len(buf) // 4)
    raw = np.frombuffer(buf, np.uint8)
    out = {}
    for name, fields in spec:
        col = _column_ref(items, name)
        if col.type != VECTOR or col.width != 4:
            raise _Fallback
        loc = _indirect(buf, col.pos, col.parent_width)
        n = _uint(buf, loc - 4, 4)
        slots = loc + 4 * np.arange(n, dtype=np.int64)
        if n == 0 or loc + 5 * n > len(buf) or (raw[loc + 4 * n:loc + 5 * n] != packed_type(MAP)).any():
            raise _Fallback
        map_loc = slots - _gather(words, _word_index(slots))
        head = _word_index(map_loc)
        keys_loc = map_loc - 12 - _gather(words, head - 3)
        k = int(_gather(words, head[:1] - 1)[0])
        if (keys_loc != keys_loc[0]).any() or (_gather(words, head - 2) != 4).any() or \
                (_gather(words, head - 1) != k).any():
            raise _Fallback
        keys = list(_map_items(buf, _Ref(int(slots[0]), 4, packed_type(MAP)), {}))
        type_pos = map_loc[:, None] + 4 * k + np.arange(k)
        if type_pos.max() >= len(buf):
            raise _Fallback
        types = raw[type_pos]
        if (types != types[0]).any():
            raise _Fallback
        parts = []
        dtype = fields[0][2]
        for key, dim, _ in fields:
            if key not in keys:
                raise ValueError(f"column {name!r}: the rows lack their {key!r} field")
            j = keys.index(key)
            value_type, code = int(types[0, j]) >> 2, int(types[0, j]) & 3
            if dim == 0:
                if value_type not in (INT, UINT, FLOAT):
                    raise _Fallback
                parts.append(_as_type(_take(words, head + j), value_type)[:, None])
                continue
            if value_type not in (VECTOR_INT, VECTOR_UINT, VECTOR_FLOAT) or code != W32:
                raise _Fallback
            vec_loc = map_loc + 4 * j - _gather(words, head + j)
            vec_head = _word_index(vec_loc)
            lengths = _gather(words, vec_head - 1)
            d = int(lengths[0])
            if (lengths != d).any():
                raise _Fallback
            if dim is not None and d != dim:
                raise ValueError(f"column {name!r}: field {key!r} holds {d} values, expected {dim}")
            parts.append(_as_type(_take(words, vec_head[:, None] + np.arange(d)), value_type - VECTOR_INT + INT))
        out[name] = np.concatenate(parts, axis=1).astype(dtype, copy=False) if len(parts) > 1 else \
            parts[0].astype(dtype, copy=False)
    return out


def _as_type(words: np.ndarray, value_type: int) -> np.ndarray:
    """32-bit words read as the value type they store."""
    return words.view("<f4") if value_type == FLOAT else words.view("<i4") if value_type == INT else words


def read_columns(data: bytes, spec: list) -> dict:
    """The columns of ``spec`` by the vectorised path where the file's
    layout allows, else element by element; ``read_columns.paths`` counts
    the files each path read."""
    try:
        out = read_columns_vectorised(data, spec)
        read_columns.paths["vectorised"] += 1
    except _Fallback:
        out = read_columns_general(data, spec)
        read_columns.paths["general"] += 1
    return out


read_columns.paths = {"vectorised": 0, "general": 0}
