"""Monitor: per-layer tensor statistics during training (``mx.Monitor``).

The PyTorch counterpart of ``mxnet_tpu/monitor.py`` (reference:
python/mxnet/monitor.py, which taps every op output through the
executor's monitor callbacks, graph_executor.cc:1343-1382). The tap
points are a Gluon block's children (``install(block)`` wraps each
child's forward) and a bound ``Executor``'s outputs (``install(exe)``,
read at ``toc``) or its per-op taps (``install_to_executor``, which
``Module.install_monitor`` calls). ``stat_func`` runs on the device; the
statistics are read back only at ``toc``.

On the steps a monitor collects (``tic`` every ``interval`` steps until
the next ``toc``), the hybridized blocks it is installed on run eagerly,
as the reference's CachedOp does in monitor mode, so the taps fire; the
other steps replay their captured graphs.
"""
from __future__ import annotations

import re

__all__ = ["Monitor"]


class Monitor:
    """Collect ``stat_func`` of the tapped outputs whose names match
    ``pattern`` on every ``interval``-th step (reference: monitor.py
    Monitor). The default statistic is ``norm(x) / sqrt(x.size)``."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                from . import nd

                return nd.norm(x) / (x.size ** 0.5)
        self.interval = interval
        self.stat_func = stat_func
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []
        self._hooks = []
        self._eager = []  # blocks switched to eager for this step

    def install(self, block_or_exe):
        """Attach to a Gluon block tree (each child's forward is wrapped)
        or to an Executor (its outputs are read at ``toc``)."""
        from .gluon.block import Block

        if isinstance(block_or_exe, Block):
            self._install_block(block_or_exe, prefix="")
        else:
            self._hooks.append(("exe", block_or_exe))
        return block_or_exe

    def _install_block(self, block, prefix):
        for name, child in block._children.items():
            cname = getattr(child, "name", None) or name
            self._install_block(child, prefix + cname + ".")
        orig = block.forward
        mon = self

        def wrapped(*args, _orig=orig, _name=prefix.rstrip("."), **kw):
            out = _orig(*args, **kw)
            if mon.activated and _name and mon.re_pattern.match(_name):
                outs = out if isinstance(out, (list, tuple)) else [out]
                for i, o in enumerate(outs):
                    if hasattr(o, "data"):
                        mon.queue.append((mon.step, f"{_name}_output{i}",
                                          mon._stat(o)))
            return out

        block.__dict__["forward"] = wrapped
        self._hooks.append(("block", block, wrapped))

    def install_to_executor(self, exe, monitor_all=False):
        """Attach to an Executor's per-op taps (reference: monitor.py
        install, through executor set_monitor_callback)."""
        mon = self

        def cb(name, arr):
            if mon.activated and mon.re_pattern.match(name):
                mon.queue.append((mon.step, name, mon._stat(arr)))

        # the executor skips its taps on steps the monitor does not
        # collect (no tic since the last toc)
        cb.mx_monitor_active = lambda: mon.activated
        exe.set_monitor_callback(cb, monitor_all=monitor_all)
        self._hooks.append(("exe_cb", exe))
        return exe

    def _stat(self, x):
        """``stat_func(x)`` off the autograd tape: a statistic taken
        inside ``record()`` must not keep the step's graph alive until
        ``toc``."""
        from . import autograd

        with autograd.pause(train_mode=autograd.is_training()):
            return self.stat_func(x)

    def uninstall(self):
        self._eager_blocks(False)
        for h in self._hooks:
            if h[0] == "block":
                if h[1].__dict__.get("forward") is h[2]:
                    del h[1].__dict__["forward"]
            elif h[0] == "exe_cb":
                h[1].set_monitor_callback(None)
        self._hooks = []

    def _eager_blocks(self, on):
        """While collecting, the tapped blocks bypass their captured
        graphs (the count the hybridized ``__call__`` checks)."""
        if on:
            for h in self._hooks:
                if h[0] == "block":
                    d = h[1].__dict__
                    d["_op_hooks_active"] = d.get("_op_hooks_active", 0) + 1
                    self._eager.append(h[1])
        else:
            for blk in self._eager:
                d = blk.__dict__
                d["_op_hooks_active"] = max(0,
                                            d.get("_op_hooks_active", 1) - 1)
            self._eager = []

    def tic(self):
        """Start a step; collect on every ``interval``-th."""
        if self.step % self.interval == 0:
            self.queue = []
            if not self.activated:
                self._eager_blocks(True)
            self.activated = True
        self.step += 1

    def toc(self):
        """End the step: ``[(step, name, statistic as text)]`` of what it
        collected, sorted by name with ``sort``."""
        if not self.activated:
            return []
        self.activated = False
        self._eager_blocks(False)
        for h in self._hooks:
            if h[0] == "exe":
                exe = h[1]
                for i, o in enumerate(getattr(exe, "outputs", [])):
                    self.queue.append((self.step, f"output{i}",
                                       self._stat(o)))
        res = []
        queue = sorted(self.queue, key=lambda q: q[1]) if self.sort \
            else self.queue
        for n, name, stat in queue:
            res.append((n, name, str(stat.asnumpy().reshape(-1)[:4])
                        if hasattr(stat, "asnumpy") else str(stat)))
        self.queue = []
        return res

    def toc_print(self):
        for n, name, stat in self.toc():
            print(f"Batch: {n:7d} {name:30s} {stat}")
