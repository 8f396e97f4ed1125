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
        """Reference: ShaderDefines::for_radix_depth_bits, src/render/mod.rs:715-722."""
        return 32 - self.value

    @property
    def digit_places(self) -> int:
        return self.value // 8


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
    """Raise for settings outside the ported slices.

    Ported: 3DGS with OBB or AABB bounds and 2DGS surfels, every rasterize
    mode but VELOCITY, every draw and sort mode, and the bounding-box
    overlay.  4DGS (and with it VELOCITY) raises ``NotImplementedError``;
    VELOCITY without 4DGS raises ``ValueError``, as the JAX package's
    projection does (ops/project.py:242-243)."""
    if settings.gaussian_mode == GaussianMode.GAUSSIAN_4D:
        raise NotImplementedError(
            "the PyTorch port renders 3DGS (OBB or AABB) and 2DGS so far; "
            f"gaussian_mode={settings.gaussian_mode.name} arrives with slice 3 (other kernel modes)"
        )
    if settings.rasterize_mode == RasterizeMode.VELOCITY:
        raise ValueError("RasterizeMode.VELOCITY requires GaussianMode.GAUSSIAN_4D")
