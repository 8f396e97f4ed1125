from bevy_gaussian_splatting_tpu_torch.models.cloud import (  # noqa: F401
    Gaussian3dCloud,
    random_gaussians_3d_seeded,
)
from bevy_gaussian_splatting_tpu_torch.models.settings import CloudSettings  # noqa: F401
from bevy_gaussian_splatting_tpu_torch.models.camera import Camera  # noqa: F401
from bevy_gaussian_splatting_tpu_torch.render.api import (  # noqa: F401
    InteractiveRenderer,
    make_replay_pipeline,
    render,
)
from bevy_gaussian_splatting_tpu_torch.render.multi_camera import (  # noqa: F401
    render_multi_camera,
    stack_cameras,
)
