"""bevy_gaussian_splatting_tpu_torch: the PyTorch and CUDA port of
``bevy_gaussian_splatting_tpu`` for NVIDIA Hopper (H100).

It mirrors the JAX package's module paths (``models/``, ``ops/``,
``render/``) and imports neither JAX nor the JAX package.  Entry points run
on the card (``cuda``) unless the caller passes ``device="cpu"``; there the
hand-written kernels under ``csrc/`` give way to their plain PyTorch
versions, which the tests hold against the JAX package.

Ported so far, for 3DGS with OBB or AABB bounds, 2DGS surfels and temporal
4DGS, in every rasterize, draw and sort mode, with or without the
bounding-box overlay, for every cloud class (quaternion and scale storage,
4DGS, precomputed covariance) at SH degrees 0-4 and in float32, float16 or
bfloat16 storage: the serving forward render, ``render.api.render``, over a
solid or a full-image background; frame-coherent serving,
``render.api.InteractiveRenderer`` (the bin and replay split,
``make_replay_pipeline``, and orbit cameras built on the device,
``models.camera.orbit_camera_device``); several cameras at once,
``render.multi_camera``; the training step, ``train.step.train_step``
(``ops.rasterize_tile.render_tiled`` is differentiable in the cloud's
tensors and the background), and the training loop's pieces:
densification (``train.densify``, 3DGS) and the convergence benchmark,
``train.quality.convergence_psnr``; PNG files (``utils.image``) and the
examples (``examples/``, run with ``python -m``); cloud and scene files
(``io/``: PLY, ``.gcloud`` / ``.gc4d`` in FlexBuffers or bincode2, ``.npz``,
KHR glTF / GLB, ``io.loader.load_any``) and multi-cloud scene rendering
(``render.scene``); selections, outliers and point-in-mesh (``query/``),
cloud interpolation and particles (``morph/``) and the noise material
(``ops.noise``).
"""

__version__ = "0.1.0"

from bevy_gaussian_splatting_tpu_torch.models.cloud import (  # noqa: F401
    Gaussian3dCloud,
    Gaussian3dCovCloud,
    Gaussian4dCloud,
    cloud_from_numpy,
    pad_cloud,
    precompute_covariance_3d,
    random_gaussians_3d,
    random_gaussians_3d_seeded,
    random_gaussians_4d,
    random_gaussians_4d_seeded,
    set_sh_degree,
    sh_coeff_width,
    sh_degree_from_width,
    test_model_3d,
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
    playback_update,
)
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera, orbit_camera_device  # noqa: F401
