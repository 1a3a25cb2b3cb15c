"""What the resilience layer's checkpoints cost, and whether a resumed run
is the uninterrupted one, on the card.

Trains ``TransformerLM`` at GPT-2-small's published widths and depth
with GPT-2's dropout of 0.1 (vocab 50257, E 768, 12 layers, 12 heads,
FFN 3072, max_len 1024, tied embedding; Xavier weights from a seed) in
bf16 AMP, hybridized (the forward and backward as CUDA graphs, K1's
bf16 kernel inside), with Adam's fused step captured, on batches of
8 x 1024 numpy-seeded tokens fed through ``pipeline.DeviceFeed``. One
step's gradient is poisoned with an inf (an AMP skip step). Three runs:

- **plain**: the uninterrupted run, no checkpoints;
- **supervised**: the same run under ``resilience.AutoResume`` with
  asynchronous checkpoints every ``--ckpt-every`` steps (``keep`` 2) and
  a fault raised in ``step_fn`` at ``--fault-at``, after the poisoned
  step; the supervisor restores the last checkpoint and replays;
- with ``--sigkill``, **two child processes** of this module: the first
  kills itself with SIGKILL as ``--kill-at`` starts (its writer may be
  mid-write), the second runs the same job and resumes from what the
  first left.

Each run's final parameters (a sha256 over their bytes), loss trace and
loss scale must equal the plain run's, bit for bit. Prints one JSON
object: the card, the snapshot's device bytes, the step thread's capture
ms per save, the writer's seconds per save, ``ckpt_async_waits``, the
restore seconds, the step ms with and without checkpoints, the bytes on
disk per checkpoint, K1's launches and the bitwise verdicts. Run on a
machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_resilience [--steps 24] \
        [--ckpt-every 8] [--fault-at 15] [--poison-at 11] [--sigkill]

``--cpu`` rehearses the same runs at a toy size on the CPU.

The checkpoints go to a temporary directory, removed at the end. The
``chip_smoke.py`` phases call :func:`lm_runs`, :func:`sigkill_runs` and
:func:`serving_resume`.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as onp
import torch

from .. import autograd, gluon, gpu, initializer, nd, random as mxrandom
from .. import resilience, serving
from ..contrib import amp
from ..gluon import fused_step
from ..kernels import _build
from ..kernels.flash_attention import FLASH_SM90_KERNEL, KERNEL as K2_KERNEL
from ..models import TransformerLM
from ..pipeline import DeviceFeed
from ..resilience import AutoResume, CheckpointManager, InjectedFault

#: GPT-2 small's published widths, depth and dropout (Radford et al.
#: 2019; the Hugging Face config's resid/embd/attn_pdrop 0.1)
GPT2_SMALL_LM = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                     num_heads=12, ffn_dim=3072, max_len=1024,
                     tie_weights=True, dropout=0.1)
BATCH, SEQ, LR, SEED = 8, 1024, 3e-4, 20240917
STEPS, EPOCHS, CKPT_EVERY, KEEP = 24, 2, 8, 2
FAULT_AT, POISON_AT, KILL_AT = 15, 11, 14
#: ``--cpu``: the same runs at a toy size on the CPU (a rehearsal: no
#: kernel of the card runs there)
TOY_LM = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
              ffn_dim=64, max_len=16, tie_weights=True, dropout=0.1)


def _size(cpu):
    """The job's model, batch and device: GPT-2 small on the card, or
    the toy on the CPU."""
    if not cpu:
        return {}
    from .. import cpu as _cpu

    return {"cfg": TOY_LM, "batch": 2, "seq": 16, "ctx": _cpu()}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def param_digest(net):
    """sha256 over every parameter's name and bytes (structural names,
    in order): equal digests are bitwise-equal parameters."""
    h = hashlib.sha256()
    for name, p in sorted(net._collect_params_with_prefix().items()):
        t = p.data().data.detach()
        h.update(name.encode())
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


class LMJob:
    """One training run's model, trainer and data (see the module
    docstring). ``step_fn`` counts the global step itself (``on_restore``
    rewinds it), poisons the step ``poison_at``, raises once at
    ``fault_at`` and SIGKILLs the process as ``kill_at`` starts."""

    def __init__(self, cfg=None, batch=BATCH, seq=SEQ, steps=STEPS,
                 epochs=EPOCHS, poison_at=POISON_AT, fault_at=None,
                 kill_at=None, ctx=None, seed=SEED):
        self.cfg = dict(cfg or GPT2_SMALL_LM)
        self.batch, self.seq, self.seed = batch, seq, seed
        self.per_epoch = steps // epochs
        self.epochs = epochs
        self.poison_at, self.fault_at, self.kill_at = \
            poison_at, fault_at, kill_at
        self.ctx = ctx or gpu(0)
        fused_step.reset_fused_step_cache()
        mxrandom.seed(seed)
        net = TransformerLM(**self.cfg)
        net.initialize(initializer.Xavier(), ctx=self.ctx)
        # the deferred shapes, in predict mode: nothing drawn, nothing
        # captured, so every process starts training from the same stream
        with autograd.pause(train_mode=False):
            net(nd.zeros((1, 8), ctx=self.ctx, dtype="int32"))
        net.hybridize()
        self.net = net
        self.trainer = gluon.Trainer(net.collect_params(), "adam",
                                     {"learning_rate": LR})
        amp.init("bfloat16")
        amp.init_trainer(self.trainer)
        self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        self.params = [p for p in net.collect_params().values()
                       if p.grad_req != "null"]
        self.g = 0
        self.steps_run = 0
        self.step_ms = {}  # global step -> ms of its last execution
        self.first_step = None  # the process's first: it captures graphs
        self.resumed_at = None

    def data(self, epoch):
        """The epoch's batches, staged on the card by a DeviceFeed;
        batch k of an epoch is the same whenever it is drawn."""
        vocab = self.cfg["vocab_size"]

        def source():
            for k in range(self.per_epoch):
                rs = onp.random.RandomState(self.seed + 1000 * epoch + k)
                yield rs.randint(0, vocab, (self.batch, self.seq)).astype(
                    "int32")

        return DeviceFeed(source(), depth=2, device=self.ctx)

    def on_restore(self, cursor):
        self.g = cursor["global_step"]
        if self.resumed_at is None:
            self.resumed_at = self.g

    def step_fn(self, toks):
        g = self.g
        if self.kill_at is not None and g == self.kill_at:
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        if self.fault_at is not None and g == self.fault_at:
            self.fault_at = None  # once
            raise InjectedFault(f"injected fault at global step {g}")
        if self.first_step is None:
            self.first_step = g
        t0 = time.perf_counter()
        vocab = self.cfg["vocab_size"]
        with autograd.record():
            logits = self.net(toks)
            loss = self.loss_fn(logits[:, :-1].reshape(-1, vocab),
                                toks[:, 1:].reshape(-1)).mean()
            with amp.scale_loss(loss, self.trainer) as scaled:
                scaled.backward()
        if g == self.poison_at:
            self.params[0].grad().data.fill_(float("inf"))
        self.trainer.step(self.batch)
        value = float(loss.asscalar())  # the trace's host read
        self.step_ms[g] = (time.perf_counter() - t0) * 1e3
        self.g = g + 1
        self.steps_run += 1
        return value

    def result(self):
        return {"digest": param_digest(self.net),
                "loss_scale": self.trainer._amp_loss_scaler.loss_scale,
                "skipped_steps": self.trainer._fused_skipped_steps()}

    def close(self):
        amp.disable()
        self.net = self.trainer = self.params = None
        _sync()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _steady_ms(step_ms, first):
    """Mean step ms over the steps that captured no graph (the first
    step a process runs captures the block's and the fused step's)."""
    vals = [v for g, v in step_ms.items() if g != first]
    return statistics.mean(vals) if vals else None


def run_plain(**kw):
    """The uninterrupted run, no checkpoints."""
    job = LMJob(**kw)
    counts0 = _build.launch_counts().get(FLASH_SM90_KERNEL, 0)
    cap0 = gluon.cached_op_stats()["captures"]
    trace = []
    t0 = time.perf_counter()
    for epoch in range(job.epochs):
        for toks in job.data(epoch):
            trace.append(job.step_fn(toks))
    _sync()
    wall = time.perf_counter() - t0
    out = job.result()
    out.update(trace=trace, wall_s=wall, steps_run=job.steps_run,
               step_ms=_steady_ms(job.step_ms, job.first_step),
               step_ms_by_step=[job.step_ms[g] for g in sorted(job.step_ms)],
               sm90_launches=_build.launch_counts().get(FLASH_SM90_KERNEL, 0)
               - counts0,
               captures=gluon.cached_op_stats()["captures"] - cap0)
    job.close()
    return out


def run_supervised(ckpt_dir, ckpt_every=CKPT_EVERY, keep=KEEP, **kw):
    """The run under AutoResume with asynchronous checkpoints, timing
    each save's capture on the step thread and each restore."""
    job = LMJob(**kw)
    counts0 = _build.launch_counts().get(FLASH_SM90_KERNEL, 0)
    cap0 = gluon.cached_op_stats()["captures"]
    c0 = resilience.resilience_counters()
    mgr = CheckpointManager(ckpt_dir, trainer=job.trainer, keep=keep,
                            async_mode=True)
    capture_ms, restore_s, snap_bytes = {}, [], []
    save, restore = mgr.save, mgr.restore

    def timed_save(step, cursor=None, extra=None):
        t = time.perf_counter()
        out = save(step, cursor=cursor, extra=extra)
        capture_ms[step] = (time.perf_counter() - t) * 1e3
        snap_bytes.append(mgr.last_snapshot_bytes)
        return out

    def timed_restore(step=None):
        t = time.perf_counter()
        out = restore(step)
        _sync()
        restore_s.append(time.perf_counter() - t)
        return out

    mgr.save, mgr.restore = timed_save, timed_restore
    sup = AutoResume(mgr, job.data, job.step_fn, epochs=job.epochs,
                     ckpt_every=ckpt_every, on_restore=job.on_restore)
    t0 = time.perf_counter()
    trace = sup.run()
    _sync()
    wall = time.perf_counter() - t0
    c1 = resilience.resilience_counters()
    d = {k: c1[k] - c0[k] for k in ("ckpt_saves", "ckpt_async_saves",
                                    "ckpt_async_waits", "ckpt_write_s",
                                    "ckpt_bytes", "ckpt_restores",
                                    "ckpt_pruned", "resume_restarts")}
    # the steps' ms with the saves' captures on the step thread: each
    # periodic save follows the step that reached its global step
    periodic = {s: ms for s, ms in capture_ms.items() if s > 0}
    with_ckpt = {g: ms + periodic.get(g + 1, 0.0)
                 for g, ms in job.step_ms.items()}
    out = job.result()
    out.update(
        trace=trace, wall_s=wall, steps_run=job.steps_run,
        restarts=sup.restarts, resumed_at=job.resumed_at,
        step_ms_by_step=[with_ckpt[g] for g in sorted(with_ckpt)],
        step_ms=_steady_ms(with_ckpt, job.first_step),
        capture_ms=capture_ms,
        capture_ms_per_save=statistics.mean(periodic.values())
        if periodic else None,
        snapshot_bytes=max(snap_bytes) if snap_bytes else 0,
        write_s_per_save=d["ckpt_write_s"] / max(d["ckpt_saves"], 1),
        disk_bytes_per_save=d["ckpt_bytes"] / max(d["ckpt_saves"], 1),
        restore_s=restore_s, counters=d,
        steps_kept=mgr.list_steps(),
        tmp_left=[n for n in os.listdir(ckpt_dir) if n.startswith(".tmp")],
        sm90_launches=_build.launch_counts().get(FLASH_SM90_KERNEL, 0)
        - counts0,
        captures=gluon.cached_op_stats()["captures"] - cap0)
    del mgr.save, mgr.restore  # the wrappers' reference cycle
    del mgr, sup
    job.close()
    return out


def check_same(name, run, ref):
    """Raise unless ``run`` ended bitwise where ``ref`` did: parameters,
    loss trace and loss scale."""
    same_trace = len(run["trace"]) == len(ref["trace"]) and onp.array_equal(
        onp.asarray(run["trace"], "float64"),
        onp.asarray(ref["trace"], "float64"), equal_nan=True)
    if run["digest"] != ref["digest"] or not same_trace or \
            run["loss_scale"] != ref["loss_scale"]:
        raise RuntimeError(
            f"{name}: not bitwise the uninterrupted run: digest "
            f"{run['digest'][:12]} vs {ref['digest'][:12]}, trace "
            f"{run['trace']} vs {ref['trace']}, loss scale "
            f"{run['loss_scale']} vs {ref['loss_scale']}")


def check_launches(name, run, layers):
    """K1's bf16 kernel: ``layers`` launches per forward, counted per
    replay; a process's forwards are its steps and one eager warm-up per
    capture."""
    want = layers * (run["steps_run"] + run["captures"])
    if run["sm90_launches"] != want or want == 0:
        raise RuntimeError(
            f"{name}: K1's sm90 kernel launched {run['sm90_launches']} "
            f"times, {want} expected ({layers} x ({run['steps_run']} steps "
            f"+ {run['captures']} capture warm-ups))")


def lm_runs(workdir, steps=STEPS, ckpt_every=CKPT_EVERY, fault_at=FAULT_AT,
            poison_at=POISON_AT, cpu=False):
    """The plain and the supervised run; raises unless they agree bitwise
    and (on the card) K1 ran on its sm90 kernel once a layer a forward."""
    size = _size(cpu)
    plain = run_plain(steps=steps, poison_at=poison_at, **size)
    sup = run_supervised(os.path.join(workdir, "lm"), ckpt_every=ckpt_every,
                         steps=steps, poison_at=poison_at, fault_at=fault_at,
                         **size)
    shutil.rmtree(os.path.join(workdir, "lm"), ignore_errors=True)
    check_same("the supervised run", sup, plain)
    if sup["restarts"] != 1 or sup["counters"]["ckpt_restores"] != 1:
        raise RuntimeError(f"the fault was not resumed once: {sup}")
    if plain["skipped_steps"] != 1 or sup["skipped_steps"] != 1:
        raise RuntimeError("the poisoned step was not skipped once: "
                           f"{plain['skipped_steps']}, {sup['skipped_steps']}")
    if sup["tmp_left"]:
        raise RuntimeError(f".tmp-* left behind: {sup['tmp_left']}")
    for name, run in (("plain", plain), ("supervised", sup)):
        if not cpu:
            check_launches(name, run, GPT2_SMALL_LM["num_layers"])
    return plain, sup


def _child(args):
    """One SIGKILL child: the supervised job in this process, its result
    as one JSON line (none when it is killed)."""
    job_kw = dict(steps=args.steps, poison_at=args.poison_at,
                  kill_at=args.kill_at, **_size(args.cpu))
    out = run_supervised(args.ckpt_dir, ckpt_every=args.ckpt_every, **job_kw)
    out.pop("capture_ms")
    print("RESULT " + json.dumps(out), flush=True)


def _run_child(ckpt_dir, steps, ckpt_every, poison_at, kill_at=None,
               cpu=False, timeout=300):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.profile_resilience",
           "--child", "--ckpt-dir", ckpt_dir, "--steps", str(steps),
           "--ckpt-every", str(ckpt_every), "--poison-at", str(poison_at)]
    if kill_at is not None:
        cmd += ["--kill-at", str(kill_at)]
    if cpu:
        cmd.append("--cpu")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=root)
    wall = time.perf_counter() - t0
    line = [s for s in proc.stdout.splitlines() if s.startswith("RESULT ")]
    return proc, (json.loads(line[-1][7:]) if line else None), wall


def sigkill_runs(workdir, ref, steps=STEPS, ckpt_every=CKPT_EVERY,
                 poison_at=POISON_AT, kill_at=KILL_AT, cpu=False):
    """The killed child and the resuming one; raises unless the second
    ends bitwise where ``ref`` (the plain run) did and no ``.tmp-*`` is
    left."""
    ckpt_dir = os.path.join(workdir, "sigkill")
    os.makedirs(ckpt_dir, exist_ok=True)
    proc, _, killed_s = _run_child(ckpt_dir, steps, ckpt_every, poison_at,
                                   kill_at=kill_at, cpu=cpu)
    if proc.returncode != -signal.SIGKILL:
        raise RuntimeError(f"the first child was not SIGKILLed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    left = sorted(os.listdir(ckpt_dir))
    proc, res, resumed_s = _run_child(ckpt_dir, steps, ckpt_every, poison_at,
                                      cpu=cpu)
    if proc.returncode != 0 or res is None:
        raise RuntimeError(f"the resuming child failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-4000:]}")
    check_same("the run resumed after SIGKILL", res, ref)
    tmp = [n for n in os.listdir(ckpt_dir) if n.startswith(".tmp")]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if tmp or res["resumed_at"] is None:
        raise RuntimeError(f"after the resume: .tmp-* {tmp}, resumed at "
                           f"{res['resumed_at']}")
    return {"left_by_kill": left, "resumed_at": res["resumed_at"],
            "restore_s": res["restore_s"], "killed_child_s": killed_s,
            "resumed_child_s": resumed_s, "steps_run": res["steps_run"],
            "sm90_launches": res["sm90_launches"],
            "captures": res["captures"], "digest": res["digest"]}


def serving_resume(net, workdir, streams=8, before=20, after=12,
                   pages=(16, 8), seed=SEED):
    """Paged decode serving closed mid-page and restored into a fresh
    session over another page size, beside an uninterrupted run of the
    same tokens: one bucket of ``streams`` rows, so every step runs the
    same shapes. Returns the continued streams' logits of both runs, K2's
    launches and graph replays per part, and the times."""
    from .profile_decode import build

    vocab = net.embed.weight.shape[0]
    layers = net._l
    rs = onp.random.RandomState(seed + 25)
    toks = {f"s{i}": rs.randint(0, vocab, (before + after, 1, 1)).astype(
        "int32") for i in range(streams)}

    def serve(bat, lo, hi):
        futs = {sid: [bat.submit(t[k], session_id=sid, slo_class="standard")
                      for k in range(lo, hi)] for sid, t in toks.items()}
        return {sid: [onp.asarray(f.result(timeout=600)) for f in fs]
                for sid, fs in futs.items()}

    def part(store, sess, lo, hi, ckpt=None):
        bat = serving.DynamicBatcher(sess, max_batch_size=streams,
                                     max_latency_ms=20.0, timeout_ms=600000,
                                     admission=False, state_checkpoint=ckpt)
        _build.reset_launch_counts()
        before_replays = sum(g["replays"] for g in
                             sess.graph_stats().values())
        t0 = time.perf_counter()
        try:
            out = serve(bat, lo, hi)
        finally:
            bat.close()  # with a checkpoint: drains, saves and waits
        wall = time.perf_counter() - t0
        replays = sum(g["replays"] for g in sess.graph_stats().values()) \
            - before_replays
        return out, {"k2_launches": _build.launch_counts().get(K2_KERNEL, 0),
                     "graph_replays": replays, "wall_s": wall,
                     "k2_per_replay": layers}

    ckpt_dir = os.path.join(workdir, "serving")
    store_u, sess_u = build(net, streams, pages[0], [streams])
    whole, whole_info = part(store_u, sess_u, 0, before + after)
    sess_u.close()
    store_u.close()
    store_a, sess_a = build(net, streams, pages[0], [streams])
    mgr_a = CheckpointManager(ckpt_dir, session_state=store_a,
                              async_mode=False)
    first, first_info = part(store_a, sess_a, 0, before, ckpt=mgr_a)
    mid_page = {sid: store_a.read(sid)[-1].item() % pages[0]
                for sid in toks}
    sess_a.close()
    store_a.close()
    serving.METRICS.reset()
    store_b, sess_b = build(net, streams, pages[1], [streams])
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir, session_state=store_b,
                      async_mode=False).restore()
    restore_s = time.perf_counter() - t0
    resumed = serving.METRICS.snapshot()["resumed_sessions"]
    rest, rest_info = part(store_b, sess_b, before, before + after)
    sess_b.close()
    store_b.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    worst, same = 0.0, True
    for sid in toks:
        for got, want in zip(first[sid] + rest[sid], whole[sid]):
            if got.shape != (1, vocab) or not onp.isfinite(got).all():
                raise RuntimeError(f"{sid}: bad logits {got.shape}")
            worst = max(worst, float(onp.abs(got - want).max()))
            same = same and onp.array_equal(got, want)
    for info in (whole_info, first_info, rest_info):
        if info["k2_launches"] != layers * info["graph_replays"] or \
                not info["graph_replays"]:
            raise RuntimeError(f"K2 not counted per graph replay: {info}")
    return {"streams": streams, "tokens_before": before,
            "tokens_after": after, "pages": list(pages),
            "mid_page_offsets": sorted(set(mid_page.values())),
            "resumed_sessions": resumed, "restore_s": restore_s,
            "bitwise": same, "max_abs_err": worst,
            "uninterrupted": whole_info, "before_close": first_info,
            "after_restore": rest_info,
            "k2_launches": whole_info["k2_launches"]
            + first_info["k2_launches"] + rest_info["k2_launches"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--ckpt-every", type=int, default=CKPT_EVERY)
    ap.add_argument("--fault-at", type=int, default=FAULT_AT)
    ap.add_argument("--poison-at", type=int, default=POISON_AT)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--sigkill", action="store_true",
                    help="also the killed and the resuming child process")
    ap.add_argument("--cpu", action="store_true",
                    help="a rehearsal at a toy size on the CPU")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("profile_resilience needs a CUDA device (--cpu "
                         "rehearses at a toy size)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.child:
        return _child(args)
    work = tempfile.mkdtemp(prefix="profile_resilience_")
    try:
        plain, sup = lm_runs(work, steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             fault_at=args.fault_at,
                             poison_at=args.poison_at, cpu=args.cpu)
        out = {"card": "cpu" if args.cpu else card(), "steps": args.steps,
               "step_ms_plain": plain["step_ms"],
               "step_ms_checkpointed": sup["step_ms"],
               "snapshot_bytes": sup["snapshot_bytes"],
               "capture_ms_per_save": sup["capture_ms_per_save"],
               "write_s_per_save": sup["write_s_per_save"],
               "disk_bytes_per_save": sup["disk_bytes_per_save"],
               "ckpt_async_waits": sup["counters"]["ckpt_async_waits"],
               "restore_s": sup["restore_s"], "bitwise": True,
               "sm90_launches": sup["sm90_launches"]}
        if args.sigkill:
            out["sigkill"] = sigkill_runs(
                work, plain, steps=args.steps, ckpt_every=args.ckpt_every,
                poison_at=args.poison_at,
                kill_at=args.kill_at if args.kill_at is not None
                else KILL_AT, cpu=args.cpu)
        print(json.dumps(out))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
