"""Asynchronous rumination shard: the edge/cloud process split on devices.

The reference ships upload bundles to an external DROID-SLAM server over ROS
actionlib and receives the CloudMap in a completion callback
(/root/reference/src/rumi-slam/src/cloud_edge_main.cpp:96,284,530 sendGoal /
:733 ActionFinishCb), so the non-realtime back-submap build runs fully
overlapped with realtime tracking.  Here the "cloud" is a rumination shard: a
worker thread that pins the backend's computation to a dedicated device of
the mesh (or a separate host in a multi-host deployment via
``jax.default_device``), while the realtime tracker keeps its own device.

The handoff is a host-staged queue of frame tensors (SURVEY.md §2.5: "the
edge->rumination image handoff becomes a host-staged tensor queue instead of
ROS messages"); results come back as CloudMap pytrees.  No locks are shared
with the tracker — the coordinator polls :meth:`poll` once per frame, exactly
where the reference's driver polls the action client.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ..config import Config
from . import cloud_map
from .backend import RuminationBackend
from .sampler import RecordedFrame


class AsyncRuminationShard:
    """Worker-thread wrapper around RuminationBackend pinned to one device."""

    def __init__(self, config: Config, *, device=None,
                 backend: Optional[RuminationBackend] = None):
        self.cfg = config
        self.backend = backend or RuminationBackend(config)
        self.device = device
        self._in: queue.Queue = queue.Queue(maxsize=2)
        self._out: queue.Queue = queue.Queue()
        self._busy = threading.Event()
        self._stop = threading.Event()
        # the exception of the last failed build (None after a success): a
        # failed build still reports (job_id, None), but is never silent
        self.last_error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side (tracking loop) -----------------------------------
    def submit(self, job_id: int, bundle: list[RecordedFrame],
               anchor_times=(), anchor_split=None) -> bool:
        """Non-blocking; returns False if the shard is saturated (the
        reference's action client also refuses overlapping goals)."""
        if self._busy.is_set():
            return False
        try:
            self._in.put_nowait(
                (job_id, bundle, tuple(anchor_times), anchor_split))
        except queue.Full:
            return False
        self._busy.set()
        return True

    def poll(self) -> Optional[tuple[int, Optional[cloud_map.CloudMap]]]:
        """(job_id, CloudMap-or-None) when a build finished, else None."""
        try:
            return self._out.get_nowait()
        except queue.Empty:
            return None

    @property
    def busy(self) -> bool:
        return self._busy.is_set()

    def shutdown(self):
        self._stop.set()
        self._in.put(None)
        self._worker.join(timeout=10)

    # -- shard side -----------------------------------------------------
    def _run(self):
        import traceback

        import jax

        from ..utils import verbose

        while not self._stop.is_set():
            item = self._in.get()
            if item is None:
                break
            job_id, bundle, anchors, split = item
            try:
                if self.device is not None:
                    with jax.default_device(self.device):
                        cm = self.backend.build(bundle, anchor_times=anchors,
                                                anchor_split=split)
                else:
                    cm = self.backend.build(bundle, anchor_times=anchors,
                                            anchor_split=split)
                self.last_error = None
            except Exception as e:
                cm = None
                self.last_error = e
                verbose.print_mess(
                    f"[rumination] build {job_id} failed:\n"
                    + "".join(traceback.format_exception(e)),
                    verbose.Level.QUIET)
            self._out.put((job_id, cm))
            self._busy.clear()


def pick_rumination_device():
    """Place the rumination shard via the global ("host","chip") mesh: the
    LAST chip of the LAST host row, so in a multi-host deployment the
    non-realtime build sits across the network from the tracker on
    host 0 chip 0 — the same place the reference pays its ROS-TCP upload
    (parallel/distributed.py layout rule).  Single-device runs return None
    (backend shares the tracker's device)."""
    import jax

    if len(jax.devices()) <= 1:
        return None
    from ..parallel.distributed import global_mesh

    try:
        mesh = global_mesh()
    except ValueError:
        # uneven topology (visible devices don't divide over hosts): the
        # strict mesh check is right for explicit collectives, but shard
        # placement only needs *a* far device — fall back to the last one
        return jax.devices()[-1]
    return mesh.devices[-1, -1]
