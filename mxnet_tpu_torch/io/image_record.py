"""ImageRecordIter, ImageDetRecordIter and LibSVMIter (CSR batches from a
LibSVM text file, parsed by ``csrc/textio.cc``).

The PyTorch counterpart of ``mxnet_tpu/io/image_record.py`` (reference:
src/io/iter_image_recordio_2.cc: chunked record read, parallel JPEG
decode and augment, batch, PrefetcherIter double buffering). Each
batch's read and decode is one op of the dependency engine on its IO
lane: ``_file_var`` orders the reads of the shared file, and one var
per prefetch slot orders the decode into the slot against its consumer.

The decode route is chosen once, by what the machine has
(``_native.decoder()``): ``"libjpeg"`` runs the JAX package's decode
(``csrc/recordio.cc``: libjpeg with DCT scaling, resize-short, crop and
mirror fused into the decode loop on ``preprocess_threads`` threads)
and gives host batches; ``"nvjpeg"`` decodes with the CUDA toolkit's
nvJPEG into the card's memory and crops with the hand kernel of
``csrc/jpeg_decode.cu`` (``kernels/jpeg_decode.py``), and gives batches
on the card. Normalization ((x - mean) / std * scale, HWC to CHW) runs
where the batch lies. A record that does not decode raises; nothing
falls back to the Python decode, :func:`_decode_batch_python`, which is
the plain twin the tests and the card's check hold the routes to.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as onp
import torch

from .io import DataIter, DataBatch, DataDesc
from .. import recordio as rio
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import host_tensor

__all__ = ["ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"]


def _index_offsets(path_imgrec, path_imgidx=None):
    """Byte offset of every record (from the .idx sidecar or a scan by
    the native frame parser)."""
    if path_imgidx and os.path.isfile(path_imgidx):
        offsets = []
        with open(path_imgidx) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) >= 2:
                    offsets.append(int(parts[1]))
        if offsets:
            return offsets
    from .. import _native

    lib = _native.io_lib()
    h = lib.rio_open(str(path_imgrec).encode())
    if not h:
        raise MXNetError(f"cannot open record file {path_imgrec}")
    offsets = []
    out = ctypes.POINTER(ctypes.c_ubyte)()
    try:
        while True:
            pos = lib.rio_tell(h)
            n = lib.rio_next(h, ctypes.byref(out))
            if n == -2:
                raise MXNetError(f"malformed record at byte {pos} of "
                                 f"{path_imgrec}")
            if n < 0:
                break
            offsets.append(pos)
    finally:
        lib.rio_close(h)
    return offsets


def _decode_batch_python(blobs, H, W, resize_short, crops):
    """The plain twin of the decode routes: PIL decode, resize-short
    (PIL's bilinear), crop and mirror, the JAX package's Python decode
    line for line (an image PIL cannot open stays zeros)."""
    from io import BytesIO
    from PIL import Image

    out = onp.zeros((len(blobs), H, W, 3), dtype=onp.uint8)
    for i, blob in enumerate(blobs):
        try:
            im = Image.open(BytesIO(blob)).convert("RGB")
        except Exception:  # noqa: BLE001 — the JAX twin's zero slot
            continue
        sw, sh = im.size
        tw, th = sw, sh
        if resize_short > 0:
            if sh < sw:
                th, tw = resize_short, max(1, sw * resize_short // sh)
            else:
                tw, th = resize_short, max(1, sh * resize_short // sw)
        # proportional cover-scale up to the crop (same order as native)
        if tw < W:
            th = th * W // tw
            tw = W
        if th < H:
            tw = tw * H // th
            th = H
        if (tw, th) != (sw, sh):
            im = im.resize((tw, th), Image.BILINEAR)
            sw, sh = tw, th
        cy, cx, mirror = crops[i]
        if cy < 0:
            cy = (sh - H) // 2
        else:
            cy = cy * (sh - H) // 10000
        if cx < 0:
            cx = (sw - W) // 2
        else:
            cx = cx * (sw - W) // 10000
        cy = min(max(cy, 0), sh - H)
        cx = min(max(cx, 0), sw - W)
        arr = onp.asarray(im)[cy:cy + H, cx:cx + W]
        if mirror:
            arr = arr[:, ::-1]
        out[i] = arr
    return out


def _decode_libjpeg(blobs, H, W, resize_short, crops, nthreads):
    """The libjpeg route (``csrc/recordio.cc`` ``decode_batch``): an HWC
    uint8 numpy batch. Raises when a record does not decode."""
    from .. import _native

    lib = _native.io_lib()
    blob = b"".join(blobs)
    lens = onp.array([len(b) for b in blobs], dtype=onp.int64)
    offs = onp.concatenate([[0], onp.cumsum(lens)[:-1]]).astype(onp.int64)
    out = onp.zeros((len(blobs), H, W, 3), dtype=onp.uint8)
    nat_crops = onp.ascontiguousarray(crops, dtype=onp.int32)
    cbuf = (ctypes.c_ubyte * max(len(blob), 1)).from_buffer_copy(
        blob or b"\0")
    failed = lib.decode_batch(
        ctypes.cast(cbuf, ctypes.POINTER(ctypes.c_ubyte)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(blobs), H, W, resize_short,
        nat_crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(nthreads), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if failed:
        raise MXNetError(f"{failed} of {len(blobs)} records in the batch "
                         "did not decode (libjpeg)")
    return out


class ImageRecordIter(DataIter):
    """Reference: ImageRecordIter v2 (src/io/iter_image_recordio_2.cc:880,
    augmenters src/io/image_aug_default.cc). Supported params mirror the
    common reference surface: data_shape, batch_size, shuffle, resize
    (short edge), rand_crop, rand_mirror, mean/std per channel, scale,
    label_width, part_index/num_parts sharding, preprocess_threads,
    prefetch_buffer, round_batch. ``device``: the card the nvJPEG route
    decodes on (default ``cuda:0``)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, resize=-1, rand_crop=False,
                 rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0, label_width=1,
                 part_index=0, num_parts=1, preprocess_threads=4,
                 prefetch_buffer=2, round_batch=True, seed=0,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 device=None, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise MXNetError("data_shape must be (3, H, W)")
        from .. import _native

        self.path_imgrec = path_imgrec
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.resize = resize
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.scale = scale
        self.round_batch = round_batch
        self.preprocess_threads = max(1, int(preprocess_threads))
        self.prefetch_buffer = max(1, int(prefetch_buffer))
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self._mean = onp.array([mean_r, mean_g, mean_b], dtype=onp.float32)
        self._std = onp.array([std_r, std_g, std_b], dtype=onp.float32)
        self._rng = onp.random.RandomState(seed)
        self.decoder = _native.decoder()
        self._device = None
        if self.decoder == "nvjpeg":
            self._device = torch.device(device or "cuda:0")

        offsets = _index_offsets(path_imgrec, path_imgidx)
        # part_index/num_parts sharding (reference: distributed data split)
        offsets = offsets[part_index::num_parts]
        if not offsets:
            raise ValueError(f"no records found in {path_imgrec}")
        self._offsets = onp.array(offsets, dtype=onp.int64)
        self._fp = open(path_imgrec, "rb")
        self._order = onp.arange(len(self._offsets))
        from .. import engine

        self._engine = engine.get()
        self._depth = self.prefetch_buffer
        self._slot_vars = []
        self._slots = [None] * self._depth
        self._nbatch = 0
        self._next_emit = 0
        self._next_push = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shp)]

    def _read_record(self, offset):
        self._fp.seek(offset)
        head = self._fp.read(8)
        magic, lrec = struct.unpack("<II", head)
        cflag, length = lrec >> 29, lrec & ((1 << 29) - 1)
        if cflag == 0:
            return self._fp.read(length)
        # split record: reassemble through the recordio module
        r = rio.MXRecordIO(self.path_imgrec, "r")
        r.fio.seek(offset)
        data = r.read()
        r.close()
        return data

    @staticmethod
    def _pad_idxs(idxs, epoch_order, bs):
        """Fill a short final batch by wrapping the epoch order (tiled, so
        shards smaller than one batch still fill up)."""
        pad = bs - len(idxs)
        if pad:
            reps = -(-pad // len(epoch_order))
            filler = onp.tile(epoch_order, reps)[:pad]
            idxs = onp.concatenate([idxs, filler])
        return idxs, pad

    def _make_label(self, lab):
        """Fixed-width label row from a record header (subclass hook)."""
        if lab.size < self.label_width:
            lab = onp.pad(lab, (0, self.label_width - lab.size))
        return lab[:self.label_width]

    def _augment_plan(self, bs):
        """Per-batch crop/mirror draws, made in epoch order outside the
        decode ops (so the draws do not depend on the engine's schedule).
        cy/cx: -1 = center; else a fraction of the free space / 10000."""
        crops = onp.full((bs, 3), -1, dtype=onp.int32)
        crops[:, 2] = 0
        if self.rand_crop:
            crops[:, 0] = self._rng.randint(0, 10001, bs)
            crops[:, 1] = self._rng.randint(0, 10001, bs)
        if self.rand_mirror:
            crops[:, 2] = self._rng.randint(0, 2, bs)
        return crops

    def _decode_job(self, idxs, pad, crops, slot):
        """One engine op: read records, decode and augment, fill the slot."""
        C, H, W = self.data_shape
        blobs, labels = [], []
        for i in idxs:
            rec = self._read_record(int(self._offsets[i]))
            header, blob = rio.unpack(rec)
            lab = onp.atleast_1d(
                onp.asarray(header.label, dtype=onp.float32))
            labels.append(self._make_label(lab))
            blobs.append(blob)
        batch_u8 = self._decode(blobs, H, W, crops)
        label = onp.stack(labels)
        if self.label_width == 1 and label.ndim == 2:
            label = label[:, 0]
        self._slots[slot] = (batch_u8, label, pad)

    def _push_decode(self):
        from .. import engine

        b = self._next_push
        idxs, pad, crops = self._plan[b]
        slot = b % self._depth
        self._engine.push(
            lambda idxs=idxs, pad=pad, crops=crops, slot=slot:
                self._decode_job(idxs, pad, crops, slot),
            mutable_vars=(self._file_var, self._slot_vars[slot]),
            lane=engine.LANE_IO, device=self._device)
        self._next_push += 1

    def _drain(self):
        """Wait out in-flight decode ops (errors from an abandoned epoch
        are dropped: reset starts fresh)."""
        for v in self._slot_vars:
            try:
                self._engine.wait_for_var(v)
            except BaseException:  # noqa: BLE001 — the epoch is abandoned
                pass

    def _decode(self, blobs, H, W, crops):
        """HWC uint8 batch: numpy on the libjpeg route, a tensor on the
        card on the nvJPEG route."""
        resize_short = self.resize if self.resize and self.resize > 0 else 0
        if self.decoder == "nvjpeg":
            from ..kernels import jpeg_decode

            return jpeg_decode.decode_batch(blobs, H, W, resize_short,
                                            crops, self._device)
        return _decode_libjpeg(blobs, H, W, resize_short, crops,
                               self.preprocess_threads)

    def reset(self):
        self._drain()
        # fresh vars each epoch: a decode error poisons its vars, and
        # poison is permanent, so reusing them would make every later
        # epoch raise the stale error again
        self._file_var = self._engine.new_variable()
        self._slot_vars = [self._engine.new_variable()
                           for _ in range(self._depth)]
        order = self._order.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        n = len(order)
        self._nbatch = (n + bs - 1) // bs if self.round_batch else n // bs
        # the epoch plan (batch indices + augmentation draws) is built up
        # front, in order; the engine ops only read and decode
        self._plan = []
        for b in range(self._nbatch):
            idxs, pad = self._pad_idxs(order[b * bs:(b + 1) * bs], order, bs)
            self._plan.append((idxs, pad, self._augment_plan(bs)))
        self._slots = [None] * self._depth
        self._next_emit = 0
        self._next_push = 0
        while self._next_push < min(self._depth, self._nbatch):
            self._push_decode()

    def next(self):
        if self._next_emit >= self._nbatch:
            raise StopIteration
        slot = self._next_emit % self._depth
        # raises the decode's error; on the card, orders this thread's
        # stream after the decode
        self._engine.wait_for_var(self._slot_vars[slot])
        batch_u8, label, pad = self._slots[slot]
        self._slots[slot] = None
        self._next_emit += 1
        if self._next_push < self._nbatch:
            self._push_decode()  # refill the slot window
        if isinstance(batch_u8, torch.Tensor):
            # made on the decode's side stream, read on this one
            batch_u8.record_stream(torch.cuda.current_stream(
                batch_u8.device))
            x = batch_u8
        else:
            x = torch.from_numpy(batch_u8)
        mean = torch.from_numpy(self._mean).to(x.device)
        std = torch.from_numpy(self._std).to(x.device)
        x = (x.float() - mean) / std * self.scale
        x = x.permute(0, 3, 1, 2).contiguous()
        if self.dtype != "float32":
            from ..ndarray.ndarray import torch_dtype

            x = x.to(torch_dtype(self.dtype))
        return DataBatch(data=[NDArray(x)],
                         label=[NDArray(host_tensor(label))], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def close(self):
        """Drain the decodes in flight and close the record file."""
        self._drain()
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class ImageDetRecordIter(ImageRecordIter):
    """Detection variant (reference: src/io/iter_image_det_recordio.cc):
    labels are variable-length [header_width, obj_width, id, xmin, ymin,
    xmax, ymax, ...] padded with -1 to label_pad_width."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_pad_width=35, label_pad_value=-1.0, **kwargs):
        self._pad_value = label_pad_value
        kwargs.setdefault("label_width", label_pad_width)
        # geometric augmentation would have to transform the boxes too;
        # the detection iterator serves center crops without mirroring
        kwargs["rand_crop"] = False
        kwargs["rand_mirror"] = False
        super().__init__(path_imgrec, data_shape, batch_size, **kwargs)

    def _make_label(self, lab):
        # pad with label_pad_value (not 0: boxes use -1 sentinel rows)
        out = onp.full(self.label_width, self._pad_value, dtype=onp.float32)
        out[:min(lab.size, self.label_width)] = lab[:self.label_width]
        return out


class LibSVMIter(DataIter):
    """Batches of CSR rows from a LibSVM text file (reference:
    src/io/iter_libsvm.cc; the JAX package's
    ``io/image_record.py:361-480``).

    The file is parsed once, at construction, by the multithreaded parser
    of ``csrc/textio.cc`` (built with ``g++`` at first use; a failed build
    or a malformed line raises :class:`MXNetError`, and there is no
    Python parse to fall back to). Labels are each line's first token, or
    the lines of ``label_libsvm``. Column ids are taken as written. Each
    batch is a ``CSRNDArray`` of shape ``(batch_size, data_shape[-1])``
    (int32 ids, float32 values) and a float32 label array, both on the
    iterator's device (``ctx``, default the current context); a short
    last batch is filled from the start of the data and ``pad`` says how
    many rows, as the JAX iterator does whatever ``round_batch`` says."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, round_batch=True, ctx=None, **kwargs):
        from ..context import resolve_device

        super().__init__(batch_size)
        self.data_shape = tuple(data_shape) if hasattr(data_shape, "__len__") \
            else (data_shape,)
        self._ncol = self.data_shape[-1]
        self._device = resolve_device(ctx)
        inline = label_libsvm is None
        values, indices, indptr, labels = _parse_libsvm(data_libsvm, inline)
        if not inline:
            with open(label_libsvm) as f:
                labels = onp.asarray([float(line.split()[0]) for line in f
                                      if line.split()], onp.float32)
            if len(labels) != len(indptr) - 1:
                raise ValueError("label_libsvm has %d rows, data has %d"
                                 % (len(labels), len(indptr) - 1))
        self._values, self._indices, self._indptr = values, indices, indptr
        self._labels = labels
        self.round_batch = round_batch
        self._cursor = 0
        self.num_data = len(labels)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._ncol))]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def _rows(self, rows):
        """The CSR parts (host tensors: float32 values, int32 ids and
        indptr) of ``rows``, in that order."""
        starts = self._indptr[rows]
        lens = self._indptr[rows + 1] - starts
        ip = onp.zeros(len(rows) + 1, onp.int64)
        onp.cumsum(lens, out=ip[1:])
        pos = onp.arange(ip[-1], dtype=onp.int64) + onp.repeat(
            starts - ip[:-1], lens)
        return (torch.from_numpy(self._values[pos]),
                torch.from_numpy(self._indices[pos].astype(onp.int32)),
                torch.from_numpy(ip.astype(onp.int32)))

    def next(self):
        from ..context import host_to_device
        from ..ndarray.sparse import CSRNDArray

        if self._cursor >= self.num_data:
            raise StopIteration
        lo = self._cursor
        hi = min(lo + self.batch_size, self.num_data)
        self._cursor = lo + self.batch_size
        pad = self.batch_size - (hi - lo)
        rows = onp.concatenate([onp.arange(lo, hi),
                                onp.arange(pad) % self.num_data])
        dev = self._device
        vals, ind, ip = (host_to_device(t, dev) for t in self._rows(rows))
        data = CSRNDArray(vals, ind, ip, (self.batch_size, self._ncol))
        label = NDArray(host_to_device(torch.from_numpy(self._labels[rows]),
                                       dev))
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def _parse_libsvm(path, inline_labels):
    """(values float32, indices int64, indptr int64, labels float32) of
    a LibSVM file, by ``csrc/textio.cc``'s parser (labels empty unless
    ``inline_labels``)."""
    from .. import _native

    lib = _native.text_lib()
    h = lib.svm_parse(str(path).encode(), 1 if inline_labels else 0)
    if not h:
        raise MXNetError(f"libsvm parse failed: "
                         f"{lib.textio_last_error().decode()}")
    try:
        rows, nnz = lib.svm_rows(h), lib.svm_nnz(h)

        def arr(ptr, n, dtype):
            if n == 0:
                return onp.zeros(0, dtype)
            return onp.ctypeslib.as_array(ptr, shape=(n,)).copy()

        return (arr(lib.svm_data(h), nnz, onp.float32),
                arr(lib.svm_indices(h), nnz, onp.int64),
                arr(lib.svm_indptr(h), rows + 1, onp.int64),
                arr(lib.svm_labels(h), rows, onp.float32)
                if inline_labels else onp.zeros(0, onp.float32))
    finally:
        lib.svm_free(h)
