from bevy_gaussian_splatting_tpu_torch.ops import (  # noqa: F401
    covariance,
    sh,
    transforms,
)
