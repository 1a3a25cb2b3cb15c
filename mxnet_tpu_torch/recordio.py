"""RecordIO: the dmlc binary record format, bit-compatible with the
reference's .rec files.

The PyTorch counterpart of ``mxnet_tpu/recordio.py`` (reference:
python/mxnet/recordio.py, MXRecordIO/MXIndexedRecordIO and the IRHeader
pack/unpack, over the dmlc-core writer and reader, interface
`dmlc/recordio.h`). Framing: every record is
[magic:u32][lrec:u32][payload][pad to 4B] with
lrec = (cflag << 29) | length; a payload that holds the magic word is
split into start/middle/end parts (cflag 1/2/3) at the magic positions,
which the reader re-inserts, so any binary payload round-trips exactly.
Files are byte for byte those of the JAX package. The native frame
parser (``csrc/recordio.cc``) serves the record iterators; this module
is the format's authority.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as onp

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_MAGIC_BYTES = struct.pack("<I", _MAGIC)


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return lrec >> 29, lrec & ((1 << 29) - 1)


class MXRecordIO:
    """Sequential .rec reader/writer (reference: recordio.py:MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.fio = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fio = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fio = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)

    def close(self):
        if self.fio is not None:
            self.fio.close()
            self.fio = None

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Override pickling behaviour (DataLoader workers)."""
        if self.writable:
            # setstate reopens with 'w', which would truncate the file and
            # drop buffered state — the reference forbids this too
            # (python/mxnet/recordio.py writable-pickle guard)
            raise RuntimeError(
                "cannot pickle a writable (MX)RecordIO instance")
        d = dict(self.__dict__)
        d["fio"] = None
        d["_pos"] = self.fio.tell() if self.fio else 0
        return d

    def __setstate__(self, d):
        pos = d.pop("_pos", None)
        self.__dict__.update(d)
        self.open()
        if pos is not None and not self.writable:
            self.fio.seek(pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Write one record; splits payload at embedded magic words the way
        dmlc-core's RecordIOWriter does."""
        if not self.writable:
            raise ValueError("write on a record file opened for reading")
        # find 4-byte-string occurrences of the magic inside the payload
        positions = []
        start = 0
        while True:
            i = buf.find(_MAGIC_BYTES, start)
            if i < 0:
                break
            positions.append(i)
            start = i + 4
        f = self.fio
        if not positions:
            f.write(_MAGIC_BYTES)
            f.write(struct.pack("<I", _encode_lrec(0, len(buf))))
            f.write(buf)
        else:
            bounds = [0] + [p for p in positions] + [len(buf)]
            nparts = len(positions) + 1
            for k in range(nparts):
                lo = bounds[k] + (4 if k > 0 else 0)
                hi = bounds[k + 1]
                part = buf[lo:hi]
                cflag = 1 if k == 0 else (3 if k == nparts - 1 else 2)
                f.write(_MAGIC_BYTES)
                f.write(struct.pack("<I", _encode_lrec(cflag, len(part))))
                f.write(part)
                pad = (-len(part)) % 4
                if pad:
                    f.write(b"\x00" * pad)
                continue
            return
        pad = (-len(buf)) % 4
        if pad:
            f.write(b"\x00" * pad)

    def read(self):
        """Read one logical record; returns None at EOF."""
        if self.writable:
            raise ValueError("read on a record file opened for writing")
        parts = []
        while True:
            head = self.fio.read(8)
            if len(head) < 8:
                if parts:
                    raise IOError("truncated split record at EOF")
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise IOError("invalid record magic at offset %d"
                              % (self.fio.tell() - 8))
            cflag, length = _decode_lrec(lrec)
            data = self.fio.read(length)
            pad = (-length) % 4
            if pad:
                self.fio.read(pad)
            if cflag == 0:
                return data
            if cflag == 1:
                parts = [data]
            else:
                parts.append(_MAGIC_BYTES)
                parts.append(data)
                if cflag == 3:
                    return b"".join(parts)

    def tell(self):
        return self.fio.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via .idx sidecar ("key\\tbyte_offset" lines).

    Reference: recordio.py:MXIndexedRecordIO."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    if len(line) < 2:
                        continue
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if self.fio is not None and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (str(key), self.idx[key]))
        super().close()

    def __getstate__(self):
        d = super().__getstate__()
        return d

    def seek(self, idx):
        if self.writable:
            raise ValueError("seek on a record file opened for writing")
        self.fio.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        if not self.writable:
            raise ValueError("write on a record file opened for reading")
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


# ------------------------------------------------------------- packing ----

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + raw bytes into a record payload (reference:
    recordio.py:pack). flag>0 means `flag` float32 labels follow the
    header."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, onp.ndarray)):
        label = onp.asarray(header.label, dtype=onp.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                       int(header.id), int(header.id2)) + s


def unpack(s):
    """Inverse of pack → (IRHeader, payload bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(s[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack header + HWC uint8 image encoded as jpg/png (reference:
    recordio.py:pack_img; uses PIL instead of cv2)."""
    from io import BytesIO
    from PIL import Image

    arr = onp.asarray(img, dtype=onp.uint8)
    im = Image.fromarray(arr)
    bio = BytesIO()
    fmt = img_fmt.lstrip(".").lower()
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}[fmt]
    if fmt == "JPEG":
        im.save(bio, format=fmt, quality=quality)
    else:
        im.save(bio, format=fmt)
    return pack(header, bio.getvalue())


def unpack_img(s, iscolor=-1):
    """Inverse of pack_img → (IRHeader, HWC uint8 ndarray)."""
    from io import BytesIO
    from PIL import Image

    header, blob = unpack(s)
    im = Image.open(BytesIO(blob))
    if iscolor == 0:
        im = im.convert("L")
    elif iscolor == 1 or (iscolor == -1 and im.mode != "L"):
        im = im.convert("RGB")
    return header, onp.asarray(im)
