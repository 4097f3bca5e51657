"""The port's multi-process modes over torch.distributed, on the CPU.

Two worker processes (``tests/torch_multihost_worker.py``) of two CPU shards
each join a Gloo group over ``tcp://127.0.0.1:<free port>``; the layout of
the JAX package's ``tests/test_multihost.py``. Each worker holds:

  * the disjoint-shard answer across processes == one process's four-shard
    ``ShardedIndex`` (ids and distances);
  * the global graph across processes (owner contribution + all_reduce)
    == the single ``Coordinator.search``;
  * ``distributed_build`` across processes == ``bulk_build`` (every table,
    the entry), and the same delete leaves equal tables;
  * the shard-parallel checkpoint reopens with equal answers;
  * an insert past the capacity re-splits the blocks across processes and
    leaves the Coordinator's tables.

The workers import torch and the port only. Each has a timeout; a worker
that fails or hangs fails the test.
"""

import json
import os
import socket
import subprocess
import sys

_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes(tmp_path):
    world = 2
    worker = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(worker))
    env["OMP_NUM_THREADS"] = "1"
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), str(world), init, str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(world)
    ]
    outputs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=_TIMEOUT_S)
            outputs.append(stdout.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{text[-4000:]}"
    for r in range(world):
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["disjoint_equal"], res
        assert res["global_equal"], res
        assert res["build_equal"], res
        assert res["delete_equal"], res
        assert res["ckpt_equal"], res
        assert res["blocks_written"] == 120, res  # its two blocks' rows
        assert res["grow_equal"], res
