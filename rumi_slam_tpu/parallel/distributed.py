"""Multi-host initialization + mesh construction.

The reference distributes by ROS TCP between an edge PC and a cloud server
(/root/reference/src/rumi-slam/launch/main.launch remappings;
CloudSlam actionlib).  The equivalent here is a JAX multi-process
runtime: each host runs this framework, ``jax.distributed`` links them over
the network, and work is placed by sharding over a global ``Mesh`` whose axes
are laid out so collectives stay on NVLink within a host and cross the
network only for the rumination hand-off (SURVEY.md §2.5: mesh axes ordered
[host, chip]).

Roles:
* ``initialize()`` — one call per process before any jax computation;
  no-op in single-process runs so the same binary serves both modes.
* ``global_mesh()`` — builds a ("host", "chip") mesh over all processes'
  devices; tracking shards frames over "chip", the rumination shard pins to
  the devices of a designated host.
* ``RUMI_COORD``/``RUMI_NUM_PROCS``/``RUMI_PROC_ID`` env contract so the
  same entry point works under any launcher (mpirun, k8s, shell).
"""

from __future__ import annotations

import os


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize jax.distributed from args or the RUMI_* env contract.

    Returns True when a multi-process runtime was set up, False for
    single-process (no env, no args) — callers need no branches; everything
    downstream just sees more devices.
    """
    import jax

    coordinator = coordinator or os.environ.get("RUMI_COORD")
    if num_processes is None:
        num_processes = int(os.environ.get("RUMI_NUM_PROCS", "0") or 0)
    if process_id is None:
        pid = os.environ.get("RUMI_PROC_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or num_processes <= 1 or process_id is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(hosts: int | None = None):
    """("host", "chip") mesh over every device of every process.

    Shardings that keep the "host" axis replicated (or reduce over "chip"
    first) confine their collectives to NVLink; only axes split over "host"
    pay network latency — the layout rule the tracking/rumination split
    follows (rumination bundles are the one cross-host transfer, by design
    the same place the reference pays its ROS-TCP upload).
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    n_hosts = hosts or max(1, jax.process_count())
    if n_hosts > len(devs):
        raise ValueError(
            f"global_mesh: {n_hosts} hosts requested but only {len(devs)} "
            "devices are visible — every host axis entry needs >=1 device"
        )
    if len(devs) % n_hosts != 0:
        raise ValueError(
            f"global_mesh: {len(devs)} devices do not divide evenly over "
            f"{n_hosts} hosts; pass hosts= explicitly or fix the topology "
            "(trailing devices would be silently dropped)"
        )
    per_host = len(devs) // n_hosts
    return Mesh(devs.reshape(n_hosts, per_host), ("host", "chip"))


def ba_mesh(max_devices: int | None = None):
    """1-D ("ba",) mesh over the visible devices for the distributed
    matrix-free PCG GBA (parallel.sharded_ba.sharded_bundle_adjust_pcg) —
    the post-merge GBA relaunch path (reference CloudMerging.cc:243-250).

    Returns None on a single device: callers fall through to the
    single-device dense-Schur solve with no mesh plumbing.
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = list(jax.devices())
    if max_devices:
        devs = devs[:max_devices]
    if len(devs) <= 1:
        return None
    return Mesh(np.asarray(devs), ("ba",))


def process_local_devices():
    import jax

    return jax.local_devices()
