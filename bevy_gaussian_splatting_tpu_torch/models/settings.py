"""Static render configuration: the pipeline-key equivalent.

A copy of the JAX package's ``models/settings.py`` enums and ``CloudSettings``
(reference ``CloudSettings`` component, src/gaussian/settings.rs:87-133), so
that both packages agree value for value.  PyTorch runs eagerly, so nothing
is compiled per key here; ``static_key()`` keys the adaptive pair budget in
``render/api.py`` the way it keys the JAX package's jitted pipelines.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class DrawMode(enum.Enum):
    """Reference: src/gaussian/settings.rs:7-12."""

    ALL = "all"
    SELECTED = "selected"
    HIGHLIGHT_SELECTED = "highlight_selected"


class GaussianMode(enum.Enum):
    """Reference: src/gaussian/settings.rs:17-22."""

    GAUSSIAN_2D = "gaussian_2d"
    GAUSSIAN_3D = "gaussian_3d"
    GAUSSIAN_4D = "gaussian_4d"


class PlaybackMode(enum.Enum):
    """Reference: src/gaussian/settings.rs:27-33."""

    LOOP = "loop"
    ONCE = "once"
    SIN = "sin"
    STILL = "still"


class RasterizeMode(enum.Enum):
    """Reference: src/gaussian/settings.rs:38-47."""

    CLASSIFICATION = "classification"
    COLOR = "color"
    DEPTH = "depth"
    NORMAL = "normal"
    OPTICAL_FLOW = "optical_flow"
    POSITION = "position"
    VELOCITY = "velocity"


class RadixSortDepthBits(enum.Enum):
    """Depth-key precision (reference: src/gaussian/settings.rs:52-77)."""

    BITS_16 = 16
    BITS_24 = 24
    BITS_32 = 32

    @property
    def bits(self) -> int:
        return self.value

    @property
    def key_shift(self) -> int:
        """``ops.sort.key_shift`` of this width."""
        from bevy_gaussian_splatting_tpu_torch.ops import sort

        return sort.key_shift(self.value)

    @property
    def digit_places(self) -> int:
        """``ops.sort.digit_places`` of this width."""
        from bevy_gaussian_splatting_tpu_torch.ops import sort

        return sort.digit_places(self.value)


class SortMode(enum.Enum):
    """Reference: src/sort/mod.rs:46-58."""

    NONE = "none"
    RADIX = "radix"
    RAYON = "rayon"
    STD = "std"


class GaussianColorSpace(enum.Enum):
    """Reference: src/gaussian/settings.rs:80-84."""

    SRGB_REC709_DISPLAY = "srgb_rec709_display"
    LIN_REC709_DISPLAY = "lin_rec709_display"


@dataclasses.dataclass(frozen=True)
class CloudSettings:
    """Per-cloud render settings; defaults mirror the reference
    (src/gaussian/settings.rs:110-132)."""

    aabb: bool = False  # False => OBB bounding quads (reference default)
    global_opacity: float = 1.0
    global_scale: float = 1.0
    opacity_adaptive_radius: bool = True
    visualize_bounding_box: bool = False
    sort_mode: SortMode = SortMode.RADIX
    radix_sort_depth_bits: RadixSortDepthBits = RadixSortDepthBits.BITS_32
    draw_mode: DrawMode = DrawMode.ALL
    gaussian_mode: GaussianMode = GaussianMode.GAUSSIAN_3D
    playback_mode: PlaybackMode = PlaybackMode.STILL
    rasterize_mode: RasterizeMode = RasterizeMode.COLOR
    color_space: GaussianColorSpace = GaussianColorSpace.SRGB_REC709_DISPLAY
    num_classes: int = 1
    time: float = 0.0
    time_scale: float = 1.0
    time_start: float = 0.0
    time_stop: float = 1.0

    def replace(self, **kwargs) -> "CloudSettings":
        return dataclasses.replace(self, **kwargs)

    def static_key(self) -> tuple:
        """The hashable subset that specializes a pipeline (everything but the
        dynamic time values; mirrors CloudPipelineKey, src/render/mod.rs:898-909)."""
        return (
            self.aabb,
            self.opacity_adaptive_radius,
            self.visualize_bounding_box,
            self.sort_mode,
            self.radix_sort_depth_bits,
            self.draw_mode,
            self.gaussian_mode,
            self.rasterize_mode,
            self.color_space,
            self.num_classes,
        )


def check_supported(settings: CloudSettings) -> None:
    """Raise for settings the port cannot render.

    Every gaussian mode is ported (3DGS with OBB or AABB bounds, 2DGS
    surfels, 4DGS), in every rasterize, draw and sort mode.  VELOCITY
    without 4DGS raises ``ValueError``, as the JAX package's projection does
    (ops/project.py:242-243)."""
    if settings.rasterize_mode == RasterizeMode.VELOCITY and settings.gaussian_mode != GaussianMode.GAUSSIAN_4D:
        raise ValueError("RasterizeMode.VELOCITY requires GaussianMode.GAUSSIAN_4D")


def playback_update(settings: CloudSettings, delta_seconds: float, elapsed_seconds: float) -> CloudSettings:
    """Advance ``settings.time`` one frame (reference ``playback_update``
    system, src/gaussian/settings.rs:145-191; the JAX package's
    models/settings.py:137-161)."""
    if settings.time_scale == 0.0:
        return settings
    mode = settings.playback_mode
    if mode == PlaybackMode.STILL:
        return settings
    if mode == PlaybackMode.ONCE and settings.time >= settings.time_stop:
        return settings
    if mode in (PlaybackMode.LOOP, PlaybackMode.ONCE):
        time = settings.time + delta_seconds * settings.time_scale
    else:  # SIN
        theta = settings.time_scale * elapsed_seconds
        y = math.sin(theta * 2.0 * math.pi)
        time = settings.time_start + (settings.time_stop - settings.time_start) * (y + 1.0) / 2.0
    if mode == PlaybackMode.LOOP and time > settings.time_stop:
        time = settings.time_start
    return settings.replace(time=time)
