"""Cloud streaming and level of detail: the counterpart of the JAX
package's ``stream/``.

- :mod:`slice`  spatial chunking of a cloud into AABB-tagged blocks, and
  exact re-assembly;
- :mod:`lod`    importance-ordered LOD chains (opacity x footprint score,
  with optional opacity-mass compensation) and distance-based level
  selection;
- :mod:`scene`  a streaming scene: chunks persisted as ``.gcloud`` files
  beside a JSON manifest, a loader thread that uploads the chunks entering
  the camera's radius to the device, eviction of far chunks, and
  power-of-two padded assembly.

The decisions (cells, scores, orders, distances) are taken on the host in
numpy with the JAX package's own calls, so that they are the same bits;
the rows move on the cloud's device.
"""

from bevy_gaussian_splatting_tpu_torch.stream.lod import build_lod_chain, select_lod
from bevy_gaussian_splatting_tpu_torch.stream.scene import StreamingCloudScene
from bevy_gaussian_splatting_tpu_torch.stream.slice import CloudChunk, concat_clouds, slice_cloud

__all__ = [
    "CloudChunk",
    "StreamingCloudScene",
    "build_lod_chain",
    "concat_clouds",
    "select_lod",
    "slice_cloud",
]
