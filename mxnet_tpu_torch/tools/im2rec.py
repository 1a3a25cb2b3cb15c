"""im2rec: build .rec/.idx packs from image folders or .lst files.

The PyTorch counterpart of ``mxnet_tpu/tools/im2rec.py`` (reference:
tools/im2rec.py and the C++ tools/im2rec.cc). The same .lst format
("index\\tlabel[\\tlabel...]\\tpath") and the same record layout, so a
pack built here reads in either package and in the reference.

    python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--list]
        [--quality Q] [--resize N] [--train-ratio R]
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as onp

from .. import recordio as rio

__all__ = ["make_list", "im2rec"]

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def make_list(root, out_prefix, shuffle=True, train_ratio=1.0, seed=0):
    """Scan `root` (one subdir per class, sorted order = label id) into
    .lst file(s). Returns list of written .lst paths."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    entries = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_IMG_EXTS):
                entries.append((label, os.path.join(cls, fname)))
    if shuffle:
        random.Random(seed).shuffle(entries)
    written = []

    def _write(path, items, start=0):
        with open(path, "w") as f:
            for i, (label, rel) in enumerate(items):
                f.write("%d\t%f\t%s\n" % (start + i, float(label), rel))
        written.append(path)

    if train_ratio >= 1.0:
        _write(out_prefix + ".lst", entries)
    else:
        k = int(len(entries) * train_ratio)
        _write(out_prefix + "_train.lst", entries[:k])
        _write(out_prefix + "_val.lst", entries[k:])
    return written


def _read_list(lst_path):
    with open(lst_path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            yield idx, labels, parts[-1]


def im2rec(lst_path, root, out_prefix, quality=95, resize=0,
           encoding=".jpg"):
    """Pack images named in `lst_path` into out_prefix.rec/.idx."""
    from PIL import Image

    record = rio.MXIndexedRecordIO(out_prefix + ".idx", out_prefix + ".rec",
                                   "w")
    count = 0
    for idx, labels, rel in _read_list(lst_path):
        path = os.path.join(root, rel)
        label = labels[0] if len(labels) == 1 else labels
        header = rio.IRHeader(0, label, idx, 0)
        if resize:
            im = Image.open(path).convert("RGB")
            w, h = im.size
            if w < h:
                tw, th = resize, max(1, h * resize // w)
            else:
                th, tw = resize, max(1, w * resize // h)
            im = im.resize((tw, th), Image.BILINEAR)
            buf = rio.pack_img(header, onp.asarray(im), quality=quality,
                               img_fmt=encoding)
        else:
            with open(path, "rb") as f:
                buf = rio.pack(header, f.read())
        record.write_idx(idx, buf)
        count += 1
    record.close()
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description="image folder → recordio pack")
    p.add_argument("prefix")
    p.add_argument("root")
    p.add_argument("--list", action="store_true",
                   help="generate .lst only")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--resize", type=int, default=0)
    p.add_argument("--train-ratio", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.list:
        make_list(args.root, args.prefix, train_ratio=args.train_ratio)
        return
    lsts = [args.prefix + s + ".lst" for s in
            ([""] if args.train_ratio >= 1.0 else ["_train", "_val"])]
    if not all(os.path.isfile(p) for p in lsts):
        lsts = make_list(args.root, args.prefix,
                         train_ratio=args.train_ratio)
    for lst in lsts:
        im2rec(lst, args.root, lst[:-len(".lst")], quality=args.quality,
               resize=args.resize)


if __name__ == "__main__":
    main()
