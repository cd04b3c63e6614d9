"""Live jax.distributed test: two OS processes form a global 8-device
CPU mesh (gloo collectives) and derive bit-identical global statistics
and codebooks from per-process read shards (SURVEY §2b item 3, the DCN
deployment shape)."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

WORKER = r'''
import sys, os
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from qvz_tpu.parallel import distributed as dist
dist.initialize(f"localhost:{port}", nproc, pid)
import numpy as np
rng = np.random.default_rng(7)  # same seed in all ranks: shared corpus
n, cols, k = 4000, 24, 3
start = rng.integers(20, 45, size=(n, 1))
steps = rng.integers(-3, 4, size=(n, cols - 1))
full = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
               71).astype(np.uint8)
cl = (np.arange(n) % k).astype(np.uint8)
lo, hi = pid * n // nproc, (pid + 1) * n // nproc
c0, cond = dist.distributed_conditional_counts(full[lo:hi], cl[lo:hi], k)

# every rank designs from the global stats: identical blocks everywhere
from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops.distortion import make_matrix
d = rt.Design(c0, cond, MODE_RATIO, 0.5, make_matrix(DISTORTION_MSE))
blocks = d.serialized()
import hashlib
print(f"RANK {pid} c0sum {int(c0.sum())} condsum {int(cond.sum())} "
      f"blocks {hashlib.sha256(blocks).hexdigest()}", flush=True)
import jax
jax.distributed.shutdown()
'''


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return env


def test_two_process_global_mesh_stats_and_design(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = _clean_env()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), "2", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail("distributed worker timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    lines = [next(ln for ln in o.splitlines() if ln.startswith("RANK"))
             for o in outs]
    f0, f1 = lines[0].split()[2:], lines[1].split()[2:]
    assert f0 == f1, f"ranks disagree: {lines}"

    # and identical to the single-process ground truth
    rng = np.random.default_rng(7)
    n, cols, k = 4000, 24, 3
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    full = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    cl = (np.arange(n) % k).astype(np.uint8)
    from qvz_tpu.native import runtime as rt
    c0, cond = rt.stats_host(full, cl, k)
    assert int(c0.sum()) == int(lines[0].split()[3])
    assert int(cond.sum()) == int(lines[0].split()[5])
    import hashlib

    from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
    from qvz_tpu.ops.distortion import make_matrix
    d = rt.Design(c0, cond, MODE_RATIO, 0.5, make_matrix(DISTORTION_MSE))
    assert hashlib.sha256(d.serialized()).hexdigest() == \
        lines[0].split()[7]
