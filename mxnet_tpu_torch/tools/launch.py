"""Multi-process job launcher and the rendezvous every rank joins.

The PyTorch counterpart of ``mxnet_tpu/tools/launch.py`` (reference:
tools/launch.py). Every process is a worker; there is no parameter
server process. The launcher starts the ranks with the rendezvous in
their environment:

  python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local \\
      python3 train.py
  python -m mxnet_tpu_torch.tools.launch -n 2 -H hosts.txt \\
      --launcher ssh python3 train.py

Each rank gets ``MXNET_COORDINATOR`` (host:port), ``MXNET_NUM_PROCESSES``
and ``MXNET_PROCESS_ID``, as the JAX launcher sets them, and
``MXNET_LOCAL_RANK``/``MXNET_LOCAL_SIZE`` (its place among the ranks of
its host). ``import mxnet_tpu_torch`` joins the process group when they
are present (:func:`init`, which a script may also call itself):
``torch.distributed.init_process_group`` with the init method
``tcp://<coordinator>``, the world size and the rank from the
environment. A rendezvous that fails raises; a rank never runs
un-joined, and a rank is never guessed.

**Backend rule.** NCCL when every rank on the host has a CUDA device of
its own (the host's ranks are no more than its cards); gloo on the CPU
and when several ranks share one card (NCCL refuses two ranks on one
device). A rank asks for the CPU with ``MXNET_DIST_DEVICE=cpu`` (the
tests do); otherwise it needs a CUDA device and raises without one. The
chosen backend either initialises or raises; nothing retries on the
other one. :func:`backend` tells which was chosen.

**Each rank's device** is explicit: ``cuda:(local_rank % device_count)``
(made current with ``torch.cuda.set_device``), or the CPU when asked
for; :func:`device` gives it as a Context.
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys

from .._rendezvous import (backend, choose_backend, coordinator,  # noqa: F401
                           device, init, is_initialized, rank, world_size)

__all__ = ["main", "init", "is_initialized", "backend", "device",
           "choose_backend", "rank", "world_size", "free_port", "run_local"]


def _worker_env(base, coord, n, rank_, local_rank, local_size):
    env = dict(base)
    env.update({"MXNET_COORDINATOR": coord,
                "MXNET_NUM_PROCESSES": str(n),
                "MXNET_PROCESS_ID": str(rank_),
                "MXNET_LOCAL_RANK": str(local_rank),
                "MXNET_LOCAL_SIZE": str(local_size)})
    return env


def _extra_env(env, pairs):
    for kv in pairs:
        k, _, v = kv.partition(":")
        env[k] = v
    return env


def _wait_all(procs):
    """Wait for every rank; when one fails, stop the others (a rank that
    died leaves its peers waiting at their next collective)."""
    import time

    rc = 0
    live = list(procs)
    while live:
        for p in list(live):
            code = p.poll()
            if code is None:
                continue
            live.remove(p)
            if code and not rc:
                rc = code
                for q in live:
                    q.terminate()
        time.sleep(0.05)
    return rc


def submit_local(args):
    coord = f"127.0.0.1:{args.port}"
    n = args.num_workers
    procs = [subprocess.Popen(args.command, env=_extra_env(
        _worker_env(os.environ, coord, n, r, r, n), args.env))
        for r in range(n)]
    return _wait_all(procs)


def submit_ssh(args):
    with open(args.host_file) as f:
        hosts = [h.strip() for h in f if h.strip()
                 and not h.startswith("#")]
    if len(hosts) < args.num_workers:
        raise SystemExit(f"host file has {len(hosts)} hosts, need "
                         f"{args.num_workers}")
    coord = f"{hosts[0]}:{args.port}"
    cmd = " ".join(shlex.quote(c) for c in args.command)
    procs = []
    for r in range(args.num_workers):
        env = _extra_env(_worker_env({}, coord, args.num_workers, r, 0, 1),
                         args.env)
        envs = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        remote = f"cd {shlex.quote(args.sync_dir or '.')} && " \
            f"env {envs} {cmd}"
        procs.append(subprocess.Popen(
            ["ssh", "-o", "StrictHostKeyChecking=no", hosts[r], remote]))
    return _wait_all(procs)


def free_port():
    """A free TCP port on this host, for a rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_local(command, n, port=None, env=None, timeout=None, cwd=None):
    """Run ``command`` (a list) as ``n`` local ranks through this
    launcher on a free port (or ``port``), with ``env`` added to this
    process's environment; returns the ``CompletedProcess`` with the
    output captured. The call's ``timeout`` kills the whole job."""
    full = dict(os.environ)
    full.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n),
         "--launcher", "local", "--port", str(port or free_port())]
        + list(command), env=full, capture_output=True, text=True,
        timeout=timeout, cwd=cwd)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Launch a distributed mxnet_tpu_torch job "
                    "(reference: tools/launch.py)")
    parser.add_argument("-n", "--num-workers", type=int, required=True,
                        help="number of processes to launch")
    parser.add_argument("-H", "--host-file", default=None,
                        help="hosts, one per line (ssh launcher)")
    parser.add_argument("--launcher", default="local",
                        choices=["local", "ssh"], help="process launcher")
    parser.add_argument("--port", type=int, default=9357,
                        help="rendezvous port")
    parser.add_argument("--sync-dir", default=None,
                        help="remote working dir (ssh)")
    parser.add_argument("--env", action="append", default=[],
                        help="VAR:value pairs for the workers")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="training command")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.launcher == "ssh" or args.host_file:
        if not args.host_file:
            parser.error("ssh launcher requires --host-file")
        return submit_ssh(args)
    return submit_local(args)


if __name__ == "__main__":
    sys.exit(main())
