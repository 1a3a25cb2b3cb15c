"""Protobuf wire codec for the ONNX IR subset, in plain Python.

The PyTorch counterpart of ``mxnet_tpu/contrib/onnx/onnx_pb2.py`` (the
``protoc`` output of ``mxnet_tpu/contrib/onnx/onnx.proto``), without
``google.protobuf``: the messages that schema declares, with its field
numbers and types, encoded and decoded by the proto3 wire rules.

- Fields are written in field-number order. A scalar without presence is
  left out at its proto3 default (0, an empty string, a float whose bits
  are all zero), a submessage is written once anything in it was set, and
  a ``oneof`` member once assigned, even at its default.
- Repeated numeric fields are packed (proto3's default, and what
  ``TensorProto`` declares); repeated strings, bytes and messages are one
  record each. A reader takes numerics packed or not.
- Fields the schema does not know are skipped on read.

``TensorProto.raw_data`` decodes as a ``memoryview`` into the buffer that
was read, so a 100 MB initializer block is never walked or copied value
by value: ``numpy.frombuffer`` reads it in place.

The message objects follow protobuf's Python API as far as the exporter
and importer use it: keyword construction, attribute access, ``add``,
``append`` and ``extend`` on repeated fields, ``HasField``,
``SerializeToString`` and ``FromString``.
"""
from __future__ import annotations

import struct

__all__ = ["AttributeProto", "ValueInfoProto", "NodeProto", "ModelProto",
           "StringStringEntryProto", "GraphProto", "TensorProto",
           "TensorShapeProto", "TypeProto", "OperatorSetIdProto",
           "DecodeError"]

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_MASK64 = (1 << 64) - 1
# wire type of each numeric kind, unpacked
_WIRE = {"int64": _VARINT, "int32": _VARINT, "uint64": _VARINT,
         "enum": _VARINT, "float": _I32, "double": _I64}
_NUMERIC = ("int64", "int32", "uint64", "enum", "float", "double")


class DecodeError(ValueError):
    """The bytes are not a well-formed message of the schema."""


class _Field:
    __slots__ = ("number", "name", "kind", "repeated", "msg", "oneof")

    def __init__(self, number, name, kind, repeated=False, msg=None,
                 oneof=None):
        self.number = number
        self.name = name
        self.kind = kind
        self.repeated = repeated
        self.msg = msg  # message class name, resolved after all exist
        self.oneof = oneof


def _coerce(kind, v):
    if kind in ("int64", "int32", "uint64", "enum"):
        return int(v)
    if kind == "float":
        return struct.unpack("<f", struct.pack("<f", float(v)))[0]
    if kind == "double":
        return float(v)
    if kind == "string":
        if isinstance(v, (bytes, bytearray)):
            return bytes(v).decode("utf-8")
        return str(v)
    if kind == "bytes":
        if isinstance(v, str):
            return v.encode("utf-8")
        return v if isinstance(v, memoryview) else bytes(v)
    raise TypeError(f"no scalar kind {kind!r}")


def _default(kind):
    if kind in ("float", "double"):
        return 0.0
    if kind == "string":
        return ""
    if kind == "bytes":
        return b""
    return 0


def _is_default(kind, v):
    if kind == "float":
        return struct.pack("<f", v) == b"\0\0\0\0"
    if kind == "double":
        return struct.pack("<d", v) == b"\0" * 8
    return not v


class _Repeated(list):
    """A repeated field: a list that marks its owner set when it grows."""

    __slots__ = ("_owner", "_field")

    def __init__(self, owner, field):
        super().__init__()
        self._owner = owner
        self._field = field

    def add(self, **kwargs):
        if self._field.kind != "message":
            raise TypeError(f"{self._field.name} holds scalars: use append")
        m = _CLASSES[self._field.msg](**kwargs)
        object.__setattr__(m, "_parent", self._owner)
        list.append(self, m)
        self._owner._touch()
        return m

    def append(self, v):
        if self._field.kind == "message":
            object.__setattr__(v, "_parent", self._owner)
            list.append(self, v)
        else:
            list.append(self, _coerce(self._field.kind, v))
        self._owner._touch()

    def extend(self, values):
        values = list(values)
        if self._field.kind == "message":
            for v in values:
                object.__setattr__(v, "_parent", self._owner)
        else:
            values = [_coerce(self._field.kind, v) for v in values]
        list.extend(self, values)
        if values:
            self._owner._touch()


class Message:
    """A message of the schema: see the module docstring."""

    _FIELDS = ()  # (_Field, ...) as declared
    _BY_NAME = {}
    _BY_NUMBER = {}
    _ORDER = ()  # fields by number: the write order

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_set", False)
        object.__setattr__(self, "_oneofs", {})
        for k, v in kwargs.items():
            f = self._field(k)
            if f.repeated:
                getattr(self, k).extend(v)
            else:
                setattr(self, k, v)

    @classmethod
    def _field(cls, name):
        f = cls._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{cls.__name__} has no field {name!r}")
        return f

    def _touch(self):
        m = self
        while m is not None and not m._set:
            object.__setattr__(m, "_set", True)
            m = m._parent

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        f = type(self)._field(name)
        values = self._values
        if name in values:
            return values[name]
        if f.repeated:
            v = values[name] = _Repeated(self, f)
            return v
        if f.kind == "message":
            m = _CLASSES[f.msg]()
            object.__setattr__(m, "_parent", self)
            values[name] = m
            return m
        return _default(f.kind)

    def __setattr__(self, name, value):
        f = type(self)._field(name)
        if f.repeated:
            raise AttributeError(
                f"assignment to repeated field {name!r}: use extend")
        if f.kind == "message":
            if not isinstance(value, _CLASSES[f.msg]):
                raise TypeError(f"{name} takes a {f.msg}")
            object.__setattr__(value, "_parent", self)
            value._touch()
        else:
            value = _coerce(f.kind, value)
        self._values[name] = value
        if f.oneof is not None:
            prev = self._oneofs.get(f.oneof)
            if prev is not None and prev != name:
                self._values.pop(prev, None)
            self._oneofs[f.oneof] = name
        self._touch()

    def HasField(self, name):  # noqa: N802 — protobuf's spelling
        f = type(self)._field(name)
        if f.repeated:
            raise ValueError(f"HasField on repeated field {name!r}")
        if f.kind == "message":
            v = self._values.get(name)
            return v is not None and v._set
        if f.oneof is not None:
            return self._oneofs.get(f.oneof) == name
        raise ValueError(f"field {name!r} has no presence in proto3")

    def __repr__(self):
        parts = []
        for f in self._FIELDS:
            if f.name in self._values:
                v = self._values[f.name]
                if isinstance(v, memoryview):
                    v = f"<{len(v)} bytes>"
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encoding ---------------------------------------------------------

    def _encode(self, out):
        """Append this message's records to ``out`` (a list of byte
        strings); returns their total length."""
        n = 0
        values = self._values
        oneofs = self._oneofs
        for f in self._ORDER:
            v = values.get(f.name)
            if v is None:
                continue
            num = f.number
            if f.repeated:
                if not v:
                    continue
                if f.kind in _NUMERIC:
                    body = _pack(f.kind, v)
                    n += _emit(out, _tag(num, _LEN) + _varint(len(body)))
                    n += _emit(out, body)
                elif f.kind == "message":
                    for m in v:
                        sub = []
                        size = m._encode(sub)
                        n += _emit(out, _tag(num, _LEN) + _varint(size))
                        out.extend(sub)
                        n += size
                else:
                    for s in v:
                        b = s.encode("utf-8") if f.kind == "string" else s
                        n += _emit(out, _tag(num, _LEN) + _varint(len(b)))
                        n += _emit(out, b)
                continue
            if f.kind == "message":
                if not v._set:
                    continue
                sub = []
                size = v._encode(sub)
                n += _emit(out, _tag(num, _LEN) + _varint(size))
                out.extend(sub)
                n += size
                continue
            if f.oneof is None or oneofs.get(f.oneof) != f.name:
                if _is_default(f.kind, v):
                    continue
            n += _emit_scalar(out, num, f.kind, v)
        return n

    def SerializeToString(self):  # noqa: N802 — protobuf's spelling
        out = []
        self._encode(out)
        return b"".join(out)

    # -- decoding ---------------------------------------------------------

    @classmethod
    def FromString(cls, data):  # noqa: N802 — protobuf's spelling
        m = cls()
        m.ParseFromString(data)
        return m

    def ParseFromString(self, data):  # noqa: N802 — protobuf's spelling
        buf = memoryview(data).cast("B") if not isinstance(data, bytes) \
            else data
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_oneofs", {})
        self._decode(buf, 0, len(buf))
        return len(buf)

    def _decode(self, buf, pos, end):
        by_number = self._BY_NUMBER
        values = self._values
        view = None
        while pos < end:
            key, pos = _read_varint(buf, pos, end)
            num, wt = key >> 3, key & 7
            if num == 0:
                raise DecodeError("field number 0")
            f = by_number.get(num)
            if f is None:
                pos = _skip(buf, pos, end, wt)
                continue
            if wt == _LEN:
                size, pos = _read_varint(buf, pos, end)
                stop = pos + size
                if stop > end:
                    raise DecodeError(f"field {f.name} runs past its end")
                if f.kind == "message":
                    m = _CLASSES[f.msg]()
                    object.__setattr__(m, "_parent", self)
                    object.__setattr__(m, "_set", True)
                    m._decode(buf, pos, stop)
                    if f.repeated:
                        lst = values.get(f.name)
                        if lst is None:
                            lst = values[f.name] = _Repeated(self, f)
                        list.append(lst, m)
                    else:
                        values[f.name] = m
                elif f.kind in ("string", "bytes"):
                    if f.kind == "string":
                        v = bytes(buf[pos:stop]).decode("utf-8")
                    elif f.name == "raw_data":
                        if view is None:
                            view = memoryview(buf)
                        v = view[pos:stop]  # read in place, not copied
                    else:
                        v = bytes(buf[pos:stop])
                    if f.repeated:
                        lst = values.get(f.name)
                        if lst is None:
                            lst = values[f.name] = _Repeated(self, f)
                        list.append(lst, v)
                    else:
                        values[f.name] = v
                elif f.repeated and f.kind in _NUMERIC:
                    lst = values.get(f.name)
                    if lst is None:
                        lst = values[f.name] = _Repeated(self, f)
                    list.extend(lst, _unpack(f.kind, buf, pos, stop))
                else:
                    raise DecodeError(f"field {f.name}: wire type 2")
                pos = stop
            else:
                if f.kind not in _NUMERIC or wt != _WIRE[f.kind]:
                    raise DecodeError(
                        f"field {f.name}: wire type {wt} for {f.kind}")
                v, pos = _read_scalar(buf, pos, end, f.kind)
                if f.repeated:
                    lst = values.get(f.name)
                    if lst is None:
                        lst = values[f.name] = _Repeated(self, f)
                    list.append(lst, v)
                else:
                    values[f.name] = v
            if f.oneof is not None:
                prev = self._oneofs.get(f.oneof)
                if prev is not None and prev != f.name:
                    values.pop(prev, None)
                self._oneofs[f.oneof] = f.name
        if pos != end:
            raise DecodeError("a record runs past the message's end")


def _emit(out, b):
    out.append(b)
    return len(b)


def _varint(v):
    v &= _MASK64
    if v < 0x80:
        return bytes((v,))
    parts = bytearray()
    while v >= 0x80:
        parts.append((v & 0x7F) | 0x80)
        v >>= 7
    parts.append(v)
    return bytes(parts)


def _tag(number, wire):
    return _varint((number << 3) | wire)


def _emit_scalar(out, num, kind, v):
    if kind in ("int64", "int32", "uint64", "enum"):
        return _emit(out, _tag(num, _VARINT) + _varint(v))
    if kind == "float":
        return _emit(out, _tag(num, _I32) + struct.pack("<f", v))
    if kind == "double":
        return _emit(out, _tag(num, _I64) + struct.pack("<d", v))
    b = v.encode("utf-8") if kind == "string" else bytes(v)
    return _emit(out, _tag(num, _LEN) + _varint(len(b))) + _emit(out, b)


def _pack(kind, values):
    if kind == "float":
        return struct.pack(f"<{len(values)}f", *values)
    if kind == "double":
        return struct.pack(f"<{len(values)}d", *values)
    return b"".join(_varint(v) for v in values)


def _read_varint(buf, pos, end):
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(kind, v):
    if kind == "int64":
        return v - (1 << 64) if v >> 63 else v
    if kind in ("int32", "enum"):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >> 31 else v
    return v


def _read_scalar(buf, pos, end, kind):
    if kind == "float":
        if pos + 4 > end:
            raise DecodeError("truncated float")
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if kind == "double":
        if pos + 8 > end:
            raise DecodeError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    v, pos = _read_varint(buf, pos, end)
    return _signed(kind, v), pos


def _unpack(kind, buf, pos, stop):
    if kind == "float":
        n, rem = divmod(stop - pos, 4)
        if rem:
            raise DecodeError("packed floats of a ragged length")
        return list(struct.unpack_from(f"<{n}f", buf, pos))
    if kind == "double":
        n, rem = divmod(stop - pos, 8)
        if rem:
            raise DecodeError("packed doubles of a ragged length")
        return list(struct.unpack_from(f"<{n}d", buf, pos))
    out = []
    while pos < stop:
        v, pos = _read_varint(buf, pos, stop)
        out.append(_signed(kind, v))
    return out


def _skip(buf, pos, end, wt):
    if wt == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wt == _I64:
        pos += 8
    elif wt == _I32:
        pos += 4
    elif wt == _LEN:
        size, pos = _read_varint(buf, pos, end)
        pos += size
    else:  # groups (3, 4) are proto2 only, 6 and 7 are not wire types
        raise DecodeError(f"wire type {wt}")
    if pos > end:
        raise DecodeError("an unknown field runs past its message")
    return pos


_CLASSES = {}


def _message(name, fields, **consts):
    """Make the message class ``name`` from ``fields``: (number, name,
    kind[, "repeated"][, message name][, oneof=...]) in declaration
    order."""
    parsed = []
    for spec in fields:
        number, fname, kind = spec[:3]
        rest = spec[3:]
        repeated = "repeated" in rest
        msg = next((r for r in rest if r not in ("repeated",)
                    and not isinstance(r, dict)), None)
        oneof = next((r["oneof"] for r in rest if isinstance(r, dict)),
                     None)
        parsed.append(_Field(number, fname, kind, repeated, msg, oneof))
    attrs = {"_FIELDS": tuple(parsed),
             "_BY_NAME": {f.name: f for f in parsed},
             "_BY_NUMBER": {f.number: f for f in parsed},
             "_ORDER": tuple(sorted(parsed, key=lambda f: f.number))}
    attrs.update(consts)
    cls = type(name, (Message,), attrs)
    _CLASSES[name] = cls
    return cls


_ONEOF_VALUE = {"oneof": "value"}

AttributeProto = _message("AttributeProto", [
    (1, "name", "string"),
    (21, "ref_attr_name", "string"),
    (13, "doc_string", "string"),
    (20, "type", "enum"),
    (2, "f", "float"),
    (3, "i", "int64"),
    (4, "s", "bytes"),
    (5, "t", "message", "TensorProto"),
    (6, "g", "message", "GraphProto"),
    (7, "floats", "float", "repeated"),
    (8, "ints", "int64", "repeated"),
    (9, "strings", "bytes", "repeated"),
    (10, "tensors", "message", "repeated", "TensorProto"),
    (11, "graphs", "message", "repeated", "GraphProto"),
], UNDEFINED=0, FLOAT=1, INT=2, STRING=3, TENSOR=4, GRAPH=5,
    SPARSE_TENSOR=11, TYPE_PROTO=13, FLOATS=6, INTS=7, STRINGS=8,
    TENSORS=9, GRAPHS=10, SPARSE_TENSORS=12, TYPE_PROTOS=14)

ValueInfoProto = _message("ValueInfoProto", [
    (1, "name", "string"),
    (2, "type", "message", "TypeProto"),
    (3, "doc_string", "string"),
])

NodeProto = _message("NodeProto", [
    (1, "input", "string", "repeated"),
    (2, "output", "string", "repeated"),
    (3, "name", "string"),
    (4, "op_type", "string"),
    (7, "domain", "string"),
    (5, "attribute", "message", "repeated", "AttributeProto"),
    (6, "doc_string", "string"),
])

ModelProto = _message("ModelProto", [
    (1, "ir_version", "int64"),
    (8, "opset_import", "message", "repeated", "OperatorSetIdProto"),
    (2, "producer_name", "string"),
    (3, "producer_version", "string"),
    (4, "domain", "string"),
    (5, "model_version", "int64"),
    (6, "doc_string", "string"),
    (7, "graph", "message", "GraphProto"),
    (14, "metadata_props", "message", "repeated", "StringStringEntryProto"),
])

StringStringEntryProto = _message("StringStringEntryProto", [
    (1, "key", "string"),
    (2, "value", "string"),
])

GraphProto = _message("GraphProto", [
    (1, "node", "message", "repeated", "NodeProto"),
    (2, "name", "string"),
    (5, "initializer", "message", "repeated", "TensorProto"),
    (10, "doc_string", "string"),
    (11, "input", "message", "repeated", "ValueInfoProto"),
    (12, "output", "message", "repeated", "ValueInfoProto"),
    (13, "value_info", "message", "repeated", "ValueInfoProto"),
])

_Segment = _message("TensorProto.Segment", [
    (1, "begin", "int64"),
    (2, "end", "int64"),
])

TensorProto = _message("TensorProto", [
    (1, "dims", "int64", "repeated"),
    (2, "data_type", "int32"),
    (3, "segment", "message", "TensorProto.Segment"),
    (4, "float_data", "float", "repeated"),
    (5, "int32_data", "int32", "repeated"),
    (6, "string_data", "bytes", "repeated"),
    (7, "int64_data", "int64", "repeated"),
    (8, "name", "string"),
    (12, "doc_string", "string"),
    (9, "raw_data", "bytes"),
    (10, "double_data", "double", "repeated"),
    (11, "uint64_data", "uint64", "repeated"),
], Segment=_Segment, UNDEFINED=0, FLOAT=1, UINT8=2, INT8=3, UINT16=4,
    INT16=5, INT32=6, INT64=7, STRING=8, BOOL=9, FLOAT16=10, DOUBLE=11,
    UINT32=12, UINT64=13, COMPLEX64=14, COMPLEX128=15, BFLOAT16=16)

_Dimension = _message("TensorShapeProto.Dimension", [
    (1, "dim_value", "int64", _ONEOF_VALUE),
    (2, "dim_param", "string", _ONEOF_VALUE),
    (3, "denotation", "string"),
])

TensorShapeProto = _message("TensorShapeProto", [
    (1, "dim", "message", "repeated", "TensorShapeProto.Dimension"),
], Dimension=_Dimension)

_TypeTensor = _message("TypeProto.Tensor", [
    (1, "elem_type", "int32"),
    (2, "shape", "message", "TensorShapeProto"),
])

TypeProto = _message("TypeProto", [
    (1, "tensor_type", "message", "TypeProto.Tensor", {"oneof": "value"}),
    (6, "denotation", "string"),
], Tensor=_TypeTensor)

OperatorSetIdProto = _message("OperatorSetIdProto", [
    (1, "domain", "string"),
    (2, "version", "int64"),
])
