"""Structure-of-arrays gaussian clouds held as tensors (float32, or float16
and bfloat16 storage through ``.astype``).

The field layouts are the JAX package's (reference attribute structs,
src/gaussian/f32.rs:30-251):

  Gaussian3dCloud      position_visibility [N, 4], spherical_harmonic
                       [N, sh_coeff_width(degree)] (interleaved rgb per
                       coefficient), rotation [N, 4] (w, x, y, z),
                       scale_opacity [N, 4]
  Gaussian4dCloud      position_visibility [N, 4], spherindrical_harmonic
                       [N, 144], isotropic_rotations [N, 8] (left and right
                       quaternions), scale_opacity [N, 4],
                       timestamp_timescale [N, 2]
  Gaussian3dCovCloud   position_visibility [N, 4], spherical_harmonic,
                       covariance_3d_opacity [N, 8] (precomputed covariance)

``cloud_from_numpy`` carries a cloud across from numpy arrays (for example
the fields of a JAX cloud), so both packages can be fed the same parameters.
The random generators are copies of the JAX package's numpy ones, so the
same seed gives bit-identical clouds in both.
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


DEFAULT_PAD_MULTIPLE: int = 256  # pad_cloud's granule (the JAX package's)

# Reference: src/material/spherindrical_harmonics.rs:20-37: spatial degree 3
# times 3 temporal harmonics, 3 channels: 144 coefficients.
SH_4D_DEGREE: int = 3
SH_4D_DEGREE_TIME: int = 2
SH_4D_COEFF_COUNT: int = pad_4(
    num_sh_coefficients(SH_4D_DEGREE) * (SH_4D_DEGREE_TIME + 1) * SH_CHANNELS
)  # 144


class _Cloud:
    """What every cloud class shares: the position and visibility column,
    the length, the AABB, and moves, casts and padding field by field."""

    @property
    def position(self) -> torch.Tensor:
        return self.position_visibility[:, :3]

    @property
    def visibility(self) -> torch.Tensor:
        return self.position_visibility[:, 3]

    @property
    def device(self) -> torch.device:
        return self.position_visibility.device

    @property
    def dtype(self) -> torch.dtype:
        return self.position_visibility.dtype

    def __len__(self) -> int:
        return self.position_visibility.shape[0]

    def compute_aabb(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(min, max) over positions [3] each (reference interface.rs:33-49)."""
        pos = self.position
        return pos.amin(dim=0), pos.amax(dim=0)

    def with_visibility(self, visibility: torch.Tensor):
        pv = self.position_visibility.clone()
        pv[:, 3] = visibility
        return dataclasses.replace(self, position_visibility=pv)

    def _map(self, fn):
        return type(self)(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device):
        return self._map(lambda t: t.to(device))

    def astype(self, dtype: torch.dtype):
        """Every field cast to ``dtype`` (f16 and bf16 storage: projection
        casts back to float32)."""
        return self._map(lambda t: t.to(dtype))

    def pad(self, multiple: int = DEFAULT_PAD_MULTIPLE):
        return pad_cloud(self, multiple)


@dataclasses.dataclass(frozen=True)
class Gaussian3dCloud(_Cloud):
    """A 3DGS cloud; 2DGS reuses it (reference: src/gaussian/formats/planar_3d.rs:56)."""

    position_visibility: torch.Tensor  # [N, 4]
    spherical_harmonic: torch.Tensor  # [N, sh_coeff_width(degree)]
    rotation: torch.Tensor  # [N, 4] (w, x, y, z)
    scale_opacity: torch.Tensor  # [N, 4]

    @property
    def scale(self) -> torch.Tensor:
        return self.scale_opacity[:, :3]

    @property
    def opacity(self) -> torch.Tensor:
        return self.scale_opacity[:, 3]


@dataclasses.dataclass(frozen=True)
class Gaussian4dCloud(_Cloud):
    """A temporal 4DGS cloud (reference: src/gaussian/formats/planar_4d.rs:40-316)."""

    position_visibility: torch.Tensor  # [N, 4]
    spherindrical_harmonic: torch.Tensor  # [N, SH_4D_COEFF_COUNT]
    isotropic_rotations: torch.Tensor  # [N, 8] (left quat wxyz, right quat wxyz)
    scale_opacity: torch.Tensor  # [N, 4]
    timestamp_timescale: torch.Tensor  # [N, 2]

    @property
    def rotation(self) -> torch.Tensor:
        return self.isotropic_rotations[:, :4]

    @property
    def rotation_r(self) -> torch.Tensor:
        return self.isotropic_rotations[:, 4:]

    @property
    def scale(self) -> torch.Tensor:
        return self.scale_opacity[:, :3]

    @property
    def opacity(self) -> torch.Tensor:
        return self.scale_opacity[:, 3]

    @property
    def timestamp(self) -> torch.Tensor:
        return self.timestamp_timescale[:, 0]

    @property
    def timescale(self) -> torch.Tensor:
        return self.timestamp_timescale[:, 1]


@dataclasses.dataclass(frozen=True)
class Gaussian3dCovCloud(_Cloud):
    """A 3DGS cloud with precomputed 3D covariance storage (the reference's
    ``precompute_covariance_3d`` feature, ``Covariance3dOpacity``,
    src/gaussian/f32.rs:232-236).

    ``covariance_3d_opacity`` columns: upper-triangular cov3d (xx, xy, xz,
    yy, yz, zz), opacity, pad.  The reference builds the covariance from
    quaternion and scale only, so projection uses it as stored: no
    model-transform conjugation and no global scale
    (src/render/gaussian_3d.wgsl:76-88)."""

    position_visibility: torch.Tensor  # [N, 4]
    spherical_harmonic: torch.Tensor  # [N, sh_coeff_width(degree)]
    covariance_3d_opacity: torch.Tensor  # [N, 8]

    @property
    def cov3d(self) -> torch.Tensor:
        return self.covariance_3d_opacity[:, :6]

    @property
    def opacity(self) -> torch.Tensor:
        return self.covariance_3d_opacity[:, 6]


# fixed column counts; the SH widths are checked by their degree
_FIELD_WIDTHS = {
    "position_visibility": 4,
    "rotation": 4,
    "scale_opacity": 4,
    "spherindrical_harmonic": SH_4D_COEFF_COUNT,
    "isotropic_rotations": 8,
    "timestamp_timescale": 2,
    "covariance_3d_opacity": 8,
}


def cloud_class(names) -> type:
    """The cloud class whose fields ``names`` holds, told apart by the field
    only that class has."""
    if "spherindrical_harmonic" in names:
        return Gaussian4dCloud
    if "covariance_3d_opacity" in names:
        return Gaussian3dCovCloud
    return Gaussian3dCloud


def cloud_from_numpy(arrays: dict, device: DeviceLike = None):
    """Build the port's cloud from numpy arrays keyed by a JAX cloud's field
    names (``{f: np.asarray(getattr(jax_cloud, f)) ...}``): a
    ``Gaussian4dCloud``, a ``Gaussian3dCovCloud`` or a ``Gaussian3dCloud``,
    as the names say, in float32."""
    dev = resolve_device(device)
    cls = cloud_class(arrays)
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [k for k in names if k not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__} arrays lack fields {missing}")
    n = np.shape(arrays["position_visibility"])[0]
    out = {}
    for name in names:
        a = np.asarray(arrays[name], np.float32)
        if a.ndim != 2 or a.shape[0] != n:
            raise ValueError(f"{name}: expected [{n}, C], got {a.shape}")
        if name in _FIELD_WIDTHS and a.shape[1] != _FIELD_WIDTHS[name]:
            raise ValueError(f"{name}: expected {_FIELD_WIDTHS[name]} columns")
        out[name] = torch.tensor(a, dtype=torch.float32, device=dev)
    if "spherical_harmonic" in out:
        sh_degree_from_width(out["spherical_harmonic"].shape[1])
    return cls(**out)


def cloud_to_numpy(cloud) -> dict:
    """The inverse of :func:`cloud_from_numpy`: the cloud's fields as float32
    numpy arrays on the host, keyed by field name (what the encoders write)."""
    return {
        f.name: getattr(cloud, f.name).detach().to(torch.float32).cpu().numpy()
        for f in dataclasses.fields(cloud)
    }


def set_sh_degree(cloud, degree: int):
    """The cloud at another SH storage degree: coefficients past ``degree``
    dropped, missing ones zero (what rebuilding the reference with another
    shN feature does to loaded assets; ``models/cloud.py:87-97`` of the JAX
    package)."""
    src = cloud.spherical_harmonic
    keep = num_sh_coefficients(degree) * SH_CHANNELS
    out = src.new_zeros((src.shape[0], sh_coeff_width(degree)))
    used = min(keep, src.shape[1])
    out[:, :used] = src[:, :used]
    return dataclasses.replace(cloud, spherical_harmonic=out)


def precompute_covariance_3d(cloud: Gaussian3dCloud, f16_quantize: bool = False) -> Gaussian3dCovCloud:
    """Quaternion and scale storage to precomputed-covariance storage
    (Covariance3dOpacity::from_gaussian, src/gaussian/f32.rs:238-250: no
    transform, no global scale).  ``f16_quantize`` rounds the covariance and
    opacity through float16, as the packed128 storage does (f16.rs:137-152)."""
    from bevy_gaussian_splatting_tpu_torch.ops.covariance import compute_cov3d

    op = cloud.opacity[:, None]
    co = torch.cat([compute_cov3d(cloud.rotation, cloud.scale), op, torch.zeros_like(op)], dim=1)
    if f16_quantize:
        co = co.to(torch.float16).to(torch.float32)
    return Gaussian3dCovCloud(
        position_visibility=cloud.position_visibility,
        spherical_harmonic=cloud.spherical_harmonic,
        covariance_3d_opacity=co,
    )


def pad_cloud(cloud, multiple: int = DEFAULT_PAD_MULTIPLE):
    """Pad along N to a multiple of ``multiple`` with inert gaussians:
    every field zero (opacity 0, visibility 0) but the quaternions, which
    are the identity (both halves of ``isotropic_rotations``), so padded
    rows give no NaN in the covariance (src/io/ply.rs:127-129)."""
    n = len(cloud)
    target = -(-n // multiple) * multiple
    if target == n:
        return cloud

    def pad_field(name: str, arr: torch.Tensor) -> torch.Tensor:
        block = arr.new_zeros((target - n, arr.shape[1]))
        if name in ("rotation", "isotropic_rotations"):
            block[:, 0::4] = 1.0
        return torch.cat([arr, block], dim=0)

    return type(cloud)(**{f.name: pad_field(f.name, getattr(cloud, f.name)) for f in dataclasses.fields(cloud)})


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


def random_gaussians_3d(n: int, sh_degree: int = SH_DEGREE, device: DeviceLike = None) -> Gaussian3dCloud:
    return cloud_from_numpy(_random_3d(np.random.default_rng(), n, sh_degree), device)


def random_gaussians_3d_seeded(
    n: int, seed: int = 0, sh_degree: int = SH_DEGREE, device: DeviceLike = None
) -> Gaussian3dCloud:
    return cloud_from_numpy(random_arrays_3d_seeded(n, seed, sh_degree), device)


def _random_4d(rng: np.random.Generator, n: int) -> dict:
    pos = rng.uniform(-20.0, 20.0, (n, 3)).astype(np.float32)
    pv = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    sh = rng.uniform(-1.0, 1.0, (n, SH_4D_COEFF_COUNT)).astype(np.float32)

    def rand_unit_quat(k):
        q = rng.uniform(-1.0, 1.0, (k, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    iso = np.concatenate([rand_unit_quat(n), rand_unit_quat(n)], axis=1)
    scale = rng.uniform(0.0, 0.5, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.8, (n, 1)).astype(np.float32)
    so = np.concatenate([scale, opacity], axis=1)
    ts = np.concatenate(
        [
            rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32),
            rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32),
        ],
        axis=1,
    )
    return {
        "position_visibility": pv,
        "spherindrical_harmonic": sh,
        "isotropic_rotations": iso,
        "scale_opacity": so,
        "timestamp_timescale": ts,
    }


def random_arrays_4d_seeded(n: int, seed: int = 0) -> dict:
    """The seeded random 4DGS cloud as numpy arrays (feed both packages)."""
    return _random_4d(np.random.default_rng(seed), n)


def random_gaussians_4d(n: int, device: DeviceLike = None) -> Gaussian4dCloud:
    return cloud_from_numpy(_random_4d(np.random.default_rng(), n), device)


def random_gaussians_4d_seeded(n: int, seed: int = 0, device: DeviceLike = None) -> Gaussian4dCloud:
    return cloud_from_numpy(random_arrays_4d_seeded(n, seed), device)


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
