from bevy_gaussian_splatting_tpu_torch.models.cloud import (  # noqa: F401
    Gaussian3dCloud,
    Gaussian3dCovCloud,
    Gaussian4dCloud,
    cloud_from_numpy,
    random_arrays_3d_seeded,
    random_arrays_4d_seeded,
    random_gaussians_3d_seeded,
    random_gaussians_4d_seeded,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings  # noqa: F401
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera  # noqa: F401
