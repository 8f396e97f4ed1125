"""Streaming scene: disk-resident chunks, uploaded to the device in the
background (``stream/scene.py`` of the JAX package).

- ``save_streaming_scene`` writes each chunk as its own ``.gcloud`` (or
  ``.gc4d``) next to a JSON manifest of chunk AABBs; the manifest is the JAX
  package's, byte for byte, and either package opens the other's scenes.
- ``StreamingCloudScene`` keeps a resident set of decoded chunks on its
  device.  A daemon thread loads the chunks whose AABB enters the camera's
  ``radius`` and ``update`` evicts chunks beyond ``radius * evict_factor``
  (hysteresis avoids thrash at the boundary).
- ``resident_cloud`` concatenates the resident chunks, padded with inert
  rows to the next power-of-two bucket, so that resident-set churn keeps
  the renderer's budget keys few.

A chunk enters the resident set only once its upload has completed: the
loader waits for its own stream before it takes the lock, so a render on
any stream reads whole tensors.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device
from bevy_gaussian_splatting_tpu_torch.models.cloud import Gaussian4dCloud
from bevy_gaussian_splatting_tpu_torch.stream.slice import CloudChunk, aabb_distance, concat_clouds

MANIFEST = "streaming_manifest.json"


def save_streaming_scene(chunks: Sequence[CloudChunk], root_dir: str) -> str:
    """Persist chunks and the manifest; returns the manifest path."""
    from bevy_gaussian_splatting_tpu_torch.io.loader import save_cloud

    os.makedirs(root_dir, exist_ok=True)
    entries = []
    for i, ch in enumerate(chunks):
        ext = ".gc4d" if isinstance(ch.cloud, Gaussian4dCloud) else ".gcloud"
        name = f"chunk_{i:05d}{ext}"
        save_cloud(ch.cloud, os.path.join(root_dir, name))
        entries.append(
            {
                "file": name,
                "aabb_min": [float(v) for v in ch.aabb_min],
                "aabb_max": [float(v) for v in ch.aabb_max],
                "cell": [int(c) for c in ch.cell],
                "count": len(ch),
            }
        )
    path = os.path.join(root_dir, MANIFEST)
    with open(path, "w") as f:
        json.dump({"chunks": entries}, f)
    return path


class StreamingCloudScene:
    """Radius-driven resident set over a saved streaming scene, held on
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        root_dir: str,
        radius: float,
        evict_factor: float = 1.5,
        background: bool = True,
        device: DeviceLike = None,
    ):
        with open(os.path.join(root_dir, MANIFEST)) as f:
            manifest = json.load(f)
        self.root_dir = root_dir
        self.radius = float(radius)
        self.evict_factor = float(evict_factor)
        self.device = resolve_device(device)
        self.entries: List[dict] = manifest["chunks"]
        self._resident: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._jobs: "queue.Queue[Optional[int]]" = queue.Queue()
        self._inflight: set = set()
        self._worker = None
        if background:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # -- worker ---------------------------------------------------------------
    def _load(self, i: int) -> None:
        from bevy_gaussian_splatting_tpu_torch.io.loader import load_cloud

        cloud = load_cloud(os.path.join(self.root_dir, self.entries[i]["file"]), device=self.device)
        if self.device.type == "cuda":
            # the upload must be complete before a render on another stream
            # (or thread) may read the chunk
            torch.cuda.current_stream(self.device).synchronize()
        with self._lock:
            # a fast-moving camera can leave the chunk's range while the load
            # is inflight; land it anyway (hysteresis): the next update()
            # evicts it.  The inflight mark is cleared in the same critical
            # section so update() sees a consistent resident/inflight pair.
            self._resident[i] = cloud
            self._inflight.discard(i)

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # a new thread starts on device 0
        while True:
            i = self._jobs.get()
            if i is None:
                return
            try:
                self._load(i)
            except Exception:  # keep the stream alive; retry on next update
                with self._lock:
                    self._inflight.discard(i)

    def close(self) -> None:
        if self._worker is not None:
            self._jobs.put(None)
            self._worker.join(timeout=5)
            self._worker = None

    # -- public API -------------------------------------------------------------
    def update(self, camera_position) -> None:
        """Schedule loads for chunks inside ``radius``; evict far chunks."""
        for i, e in enumerate(self.entries):
            d = aabb_distance(e["aabb_min"], e["aabb_max"], camera_position)
            # membership check + inflight insertion in ONE critical section:
            # concurrent update() calls must not double-schedule a chunk
            with self._lock:
                resident = i in self._resident
                inflight = i in self._inflight
                schedule = d <= self.radius and not resident and not inflight
                if schedule:
                    self._inflight.add(i)
            if schedule:
                if self._worker is not None:
                    self._jobs.put(i)
                else:
                    try:
                        self._load(i)
                    except Exception:
                        # mirror the worker's recovery: clear the inflight
                        # mark so the next update() can retry the chunk
                        with self._lock:
                            self._inflight.discard(i)
                        raise
            elif d > self.radius * self.evict_factor and resident:
                with self._lock:
                    self._resident.pop(i, None)

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until every scheduled load has landed."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._lock:
                if not self._inflight:
                    return
            time.sleep(0.01)
        raise TimeoutError("streaming loads did not settle")

    def resident_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._resident)

    def resident_cloud(self, bucket: bool = True):
        """One renderable cloud from the resident set (None when empty).

        ``bucket=True`` pads with inert rows to the next power of two (at
        least 256), as the JAX package does to re-use compiled pipelines."""
        with self._lock:
            clouds = [self._resident[i] for i in sorted(self._resident)]
        if not clouds:
            return None
        cloud = clouds[0] if len(clouds) == 1 else concat_clouds(clouds)
        if bucket:
            n = len(cloud)
            size = 1 << max(8, int(np.ceil(np.log2(max(n, 1)))))
            cloud = cloud.pad(multiple=size)
        return cloud
