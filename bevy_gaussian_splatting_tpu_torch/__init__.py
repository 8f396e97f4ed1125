"""bevy_gaussian_splatting_tpu_torch: the PyTorch and CUDA port of
``bevy_gaussian_splatting_tpu`` for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths (``models/``, ``ops/``,
``render/``) and imports neither JAX nor the JAX package.  Entry points run
on the card (``cuda``) unless the caller passes ``device="cpu"``; there the
hand-written kernels under ``csrc/`` give way to their plain PyTorch
versions, which the tests hold against the JAX package.

Ported so far: the serving forward render of the default configuration
(3DGS, OBB bounds, COLOR mode), ``render.api.render``.
"""

__version__ = "0.1.0"

from bevy_gaussian_splatting_tpu_torch.models.cloud import (  # noqa: F401
    Gaussian3dCloud,
    cloud_from_numpy,
    random_gaussians_3d_seeded,
    sh_coeff_width,
    sh_degree_from_width,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import (  # noqa: F401
    CloudSettings,
    DrawMode,
    GaussianMode,
    GaussianColorSpace,
    PlaybackMode,
    RadixSortDepthBits,
    RasterizeMode,
    SortMode,
)
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera  # noqa: F401
