"""Structure-of-arrays gaussian cloud held as float32 tensors.

The field layout is the JAX package's ``Gaussian3dCloud`` (reference
attribute structs, src/gaussian/f32.rs:30-251):

  position_visibility  [N, 4]   xyz + visibility
  spherical_harmonic   [N, 48]  SH degree 3, interleaved rgb per coefficient
  rotation             [N, 4]   quaternion (w, x, y, z)
  scale_opacity        [N, 4]   scale xyz + opacity

``cloud_from_numpy`` carries a cloud across from numpy arrays (for example
the fields of a JAX cloud), so both packages can be fed the same parameters.
The random generator is a copy of the JAX package's numpy one, so the same
seed gives bit-identical clouds in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike, resolve_device

# Reference: src/material/spherical_harmonics.rs:44-81, default SH degree 3:
# 16 coefficients x 3 channels = 48 f32.
SH_DEGREE: int = 3
SH_CHANNELS: int = 3
SH_MAX_DEGREE: int = 4


def num_sh_coefficients(degree: int) -> int:
    """Per-channel SH coefficient count: (degree + 1)^2
    (src/material/spherical_harmonics.rs:33-40)."""
    return (degree + 1) ** 2


def pad_4(x: int) -> int:
    return (x + 3) // 4 * 4


SH_COEFF_COUNT_PER_CHANNEL: int = num_sh_coefficients(SH_DEGREE)  # 16
SH_COEFF_COUNT: int = pad_4(SH_COEFF_COUNT_PER_CHANNEL * SH_CHANNELS)  # 48


def sh_coeff_width(degree: int) -> int:
    """Padded [N, C] column count for a given SH degree (pad_4(3 * (d+1)^2))."""
    if not 0 <= degree <= SH_MAX_DEGREE:
        raise ValueError(f"SH degree must be in [0, {SH_MAX_DEGREE}], got {degree}")
    return pad_4(num_sh_coefficients(degree) * SH_CHANNELS)


_SH_WIDTH_TO_DEGREE = {sh_coeff_width(d): d for d in range(SH_MAX_DEGREE + 1)}


def sh_degree_from_width(width: int) -> int:
    """Inverse of :func:`sh_coeff_width`: the storage degree of a cloud's
    ``spherical_harmonic`` array."""
    try:
        return _SH_WIDTH_TO_DEGREE[int(width)]
    except KeyError:
        raise ValueError(
            f"spherical_harmonic width {width} is not a padded sh0..sh4 layout "
            f"(expected one of {sorted(_SH_WIDTH_TO_DEGREE)})"
        ) from None


@dataclasses.dataclass(frozen=True)
class Gaussian3dCloud:
    """A 3DGS cloud (reference: src/gaussian/formats/planar_3d.rs:56)."""

    position_visibility: torch.Tensor  # [N, 4]
    spherical_harmonic: torch.Tensor  # [N, sh_coeff_width(degree)]
    rotation: torch.Tensor  # [N, 4] (w, x, y, z)
    scale_opacity: torch.Tensor  # [N, 4]

    @property
    def position(self) -> torch.Tensor:
        return self.position_visibility[:, :3]

    @property
    def visibility(self) -> torch.Tensor:
        return self.position_visibility[:, 3]

    @property
    def scale(self) -> torch.Tensor:
        return self.scale_opacity[:, :3]

    @property
    def opacity(self) -> torch.Tensor:
        return self.scale_opacity[:, 3]

    @property
    def device(self) -> torch.device:
        return self.position_visibility.device

    def __len__(self) -> int:
        return self.position_visibility.shape[0]

    def compute_aabb(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(min, max) over positions [3] each (reference interface.rs:33-49)."""
        pos = self.position
        return pos.amin(dim=0), pos.amax(dim=0)

    def to(self, device) -> "Gaussian3dCloud":
        return Gaussian3dCloud(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


_FIELD_WIDTHS = {
    "position_visibility": 4,
    "rotation": 4,
    "scale_opacity": 4,
}


def cloud_from_numpy(
    arrays: dict, device: DeviceLike = None
) -> Gaussian3dCloud:
    """Build the port's cloud from numpy arrays keyed by the JAX cloud's
    field names (``{f: np.asarray(getattr(jax_cloud, f)) ...}``)."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(Gaussian3dCloud)]
    missing = [k for k in names if k not in arrays]
    if missing:
        raise KeyError(f"cloud arrays lack fields {missing}")
    n = np.shape(arrays["position_visibility"])[0]
    out = {}
    for name in names:
        a = np.asarray(arrays[name], np.float32)
        if a.ndim != 2 or a.shape[0] != n:
            raise ValueError(f"{name}: expected [{n}, C], got {a.shape}")
        if name in _FIELD_WIDTHS and a.shape[1] != _FIELD_WIDTHS[name]:
            raise ValueError(f"{name}: expected {_FIELD_WIDTHS[name]} columns")
        out[name] = torch.tensor(a, dtype=torch.float32, device=dev)
    sh_degree_from_width(out["spherical_harmonic"].shape[1])
    return Gaussian3dCloud(**out)


# ---------------------------------------------------------------------------
# Generators (reference: src/gaussian/formats/planar_3d.rs:120-236).  A copy
# of the JAX package's numpy generator: same draws, same order, same bits.
# ---------------------------------------------------------------------------


def _random_3d(rng: np.random.Generator, n: int, sh_degree: int = SH_DEGREE) -> dict:
    pos = rng.uniform(-20.0, 20.0, (n, 3)).astype(np.float32)
    pv = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    sh = rng.uniform(-1.0, 1.0, (n, sh_coeff_width(sh_degree))).astype(np.float32)
    sh[:, num_sh_coefficients(sh_degree) * 3 :] = 0.0  # pad_4 slots stay zero
    rot = rng.uniform(-1.0, 1.0, (n, 4)).astype(np.float32)
    scale = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.0, 0.8, (n, 1)).astype(np.float32)
    so = np.concatenate([scale, opacity], axis=1)
    return {
        "position_visibility": pv,
        "spherical_harmonic": sh,
        "rotation": rot,
        "scale_opacity": so,
    }


def random_arrays_3d_seeded(n: int, seed: int = 0, sh_degree: int = SH_DEGREE) -> dict:
    """The seeded random cloud as numpy arrays (feed both packages)."""
    return _random_3d(np.random.default_rng(seed), n, sh_degree)


def random_gaussians_3d_seeded(
    n: int, seed: int = 0, sh_degree: int = SH_DEGREE, device: DeviceLike = None
) -> Gaussian3dCloud:
    return cloud_from_numpy(random_arrays_3d_seeded(n, seed, sh_degree), device)


def surfel_grid_arrays(n_side: int = 4, seed: int = 5) -> dict:
    """The 2DGS debug fixture as numpy arrays: an ``n_side`` x ``n_side``
    grid of flat disks (scale z 1e-3) on the z = 0 plane, drawn as the JAX
    package's ``tools/surfel_plane.py`` ``make_surfel_grid`` draws it (seen
    there from eye (2.5, 2, 6))."""
    rng = np.random.default_rng(seed)
    n = n_side * n_side
    xs, ys = np.meshgrid(np.linspace(-2, 2, n_side), np.linspace(-2, 2, n_side))
    pos = np.stack([xs.ravel(), ys.ravel(), np.zeros(n)], axis=1).astype(np.float32)
    sh = np.zeros((n, 48), np.float32)
    sh[:, :3] = rng.uniform(-1.0, 1.5, (n, 3))
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    so = np.concatenate(
        [np.tile(np.array([[0.35, 0.35, 1e-3]], np.float32), (n, 1)), np.full((n, 1), 0.85, np.float32)],
        axis=1,
    )
    return {
        "position_visibility": np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1),
        "spherical_harmonic": sh,
        "rotation": quat,
        "scale_opacity": so,
    }


def test_model_3d(seed: Optional[int] = 42, device: DeviceLike = None) -> Gaussian3dCloud:
    """The deterministic 9-gaussian test cloud: the 8 cube corners at +-0.5
    plus a duplicate of the first corner (reference TestCloud::test_model,
    src/gaussian/formats/planar_3d.rs:190-247), drawn as the JAX package's
    ``test_model_3d`` draws it; on the card unless ``device`` says
    otherwise."""
    rng = np.random.default_rng(seed)
    base_sh = rng.uniform(-1.0, 1.0, SH_COEFF_COUNT).astype(np.float32)
    rows = []
    for x in (-0.5, 0.5):
        for y in (-0.5, 0.5):
            for z in (-0.5, 0.5):
                sh = base_sh.copy()
                rng.shuffle(sh)
                rows.append((np.array([x, y, z, 1.0], np.float32), sh))
    rows.append(rows[0])
    n = len(rows)
    arrays = {
        "position_visibility": np.stack([r[0] for r in rows]),
        "spherical_harmonic": np.stack([r[1] for r in rows]),
        "rotation": np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
        "scale_opacity": np.tile(np.array([0.125, 0.125, 0.125, 0.125], np.float32), (n, 1)),
    }
    return cloud_from_numpy(arrays, device)
