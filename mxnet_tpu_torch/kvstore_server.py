"""KVStore server entry point (reference: python/mxnet/kvstore_server.py).

The PyTorch counterpart of ``mxnet_tpu/kvstore_server.py``. The
reference starts dedicated server and scheduler processes (ps-lite);
here every process is a worker: ``dist_sync`` sums with collectives and
``dist_async``'s server runs on rank 0's applier thread
(``kvstore_ps.py``). A script started with ``DMLC_ROLE=server`` or
``=scheduler`` (what the reference's launchers set on the extra
processes) exits at import instead of training a duplicate worker, as
the reference's ``_init_kvstore_server_module`` never returns to the
user script on those roles.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer"]


class KVStoreServer:
    """API-parity shim for the reference's blocking server loop."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def _controller(self):
        def server_controller(cmd_id, cmd_body, _):
            logging.info("kvstore server command (%s, %s) ignored: there "
                         "is no parameter-server process", cmd_id, cmd_body)

        return server_controller

    def run(self):
        logging.info("KVStoreServer.run(): nothing to run; the workers "
                     "reduce with collectives, and dist_async's server "
                     "runs on rank 0's applier thread")


def _init_kvstore_server_module():
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role in ("server", "scheduler"):
        logging.warning("DMLC_ROLE=%s: no %s processes are needed "
                        "(every process is a worker); exiting", role, role)
        sys.exit(0)


_init_kvstore_server_module()
