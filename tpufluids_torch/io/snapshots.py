"""Asynchronous snapshot path: ``tpufluids.io.snapshots`` for the port.

The drivers hand a snapshot over as CPU tensors (``step.run``'s
``snapshot_fn``); writing the VTK frame happens on a background thread,
so the next steps are enqueued on the device at once.
"""

from __future__ import annotations

import os
import queue
import threading

from tpufluids_torch.io.vtk import write_particle_snapshot


class SnapshotWriter:
    """Background VTK frame writer; frames are numbered from 0.

    Usage::

        snap = SnapshotWriter(out_dir, prefix="anim_s_GPU0_")
        step.run(state, cfg, steps, snapshot_every=20, snapshot_fn=snap)
        snap.close()

    A failed write raises on the next call or on ``close``.
    """

    def __init__(self, out_dir: str, prefix: str = "frame_",
                 varnames=("mass", "surface_level"), use_binary=False,
                 cfg=None, max_queue: int = 4):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.prefix = prefix
        self.varnames = varnames
        self.use_binary = use_binary
        self.cfg = cfg
        self.frame = 0
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._err = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def __call__(self, step: int, host_state) -> None:
        if self._err is not None:
            raise self._err
        path = os.path.join(self.out_dir, f"{self.prefix}{self.frame}.vtk")
        self.frame += 1
        self._q.put((path, host_state))

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            path, state = item
            try:
                write_particle_snapshot(path, state, cfg=self.cfg,
                                        varnames=self.varnames,
                                        use_binary=self.use_binary)
            except Exception as e:  # surfaced on next call / close
                self._err = e

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise self._err
