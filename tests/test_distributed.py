"""Multi-host path: jax.distributed over two real processes.

The virtual 8-device CPU mesh exercises SPMD semantics but not the
multi-process runtime; this test launches TWO separate interpreters linked
by ``parallel.distributed.initialize`` over localhost — the same wiring a
real two-host deployment uses over the network (SURVEY.md §2.5: the
reference's edge/cloud ROS TCP split re-expressed as a JAX process group).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.environ["RUMI_REPO"])
import jax
jax.config.update("jax_platforms", "cpu")
from rumi_slam_tpu.parallel import distributed

assert distributed.initialize(), "env contract did not trigger init"
assert jax.process_count() == 2
mesh = distributed.global_mesh()
assert mesh.devices.shape == (2, 2), mesh.devices.shape

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

# each process contributes its local rows; the psum crosses processes
def f(x):
    return jax.lax.psum(x, ("host", "chip"))

xs = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P(("host", "chip"))),
    jnp.full((2,), float(jax.process_index() + 1), jnp.float32),
    (4,),
)
out = jax.jit(
    jax.shard_map(f, mesh=mesh, in_specs=P(("host", "chip")), out_specs=P()),
    out_shardings=NamedSharding(mesh, P()),
)(xs)
# sum over 4 device rows: process0 contributes 1+1, process1 2+2
import numpy as np
got = float(np.asarray(jax.block_until_ready(out).addressable_data(0)).ravel()[0])
assert got == 6.0, got
print("DIST_OK", jax.process_index())
"""


@pytest.mark.slow
def test_two_process_distributed_psum(tmp_path):
    env_base = dict(os.environ)
    env_base["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    env_base["RUMI_REPO"] = os.path.dirname(os.path.dirname(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["RUMI_COORD"] = f"127.0.0.1:{port}"
        env["RUMI_NUM_PROCS"] = "2"
        env["RUMI_PROC_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        assert "DIST_OK" in out
