"""Noise material: every SH coefficient rewritten from the gaussian's position
(reference: src/material/noise.rs:28-56, ridged-multifractal noise sampled at
(position * scale, coefficient index)), as the JAX package's
``ops/noise.py`` computes it: ridged multifractal over a 4D gradient-noise
base (|noise| inverted, squared-gain octaves, 6 octaves, lacunarity 2 pi / 3,
the Rust ``noise`` crate's RidgedMulti defaults), broadcast over gaussians x
coefficients on the cloud's device.

The lattice hash is uint32 arithmetic that wraps, and PyTorch multiplies no
uint32 on either device.  It runs in int64 on values below 2^32: a product
is split at 16 bits of the constant so that no partial product reaches 2^63,
and every sum and product is masked back to 32 bits.  A negative lattice
coordinate wraps to 2^32 + c, as JAX's int32 -> uint32 cast does.  The
float operations are the JAX package's, one by one in its order.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_OCTAVES = 6
DEFAULT_LACUNARITY = 2.0943951023931953  # pi * 2/3 (noise crate default)
DEFAULT_PERSISTENCE = 1.0
DEFAULT_ATTENUATION = 2.0
MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant ``c`` in
    [0, 2^32), with every partial product below 2^48."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _hash4(ix, iy, iz, iw, seed: int) -> torch.Tensor:
    """Integer lattice hash -> uint32 values held in int64 (xxhash-style
    avalanche mix).  ``ix``..``iw`` are integer tensors that broadcast."""
    h = (
        _mul32(ix.to(torch.int64) & MASK32, 0x8DA6B343)
        + _mul32(iy.to(torch.int64) & MASK32, 0xD8163841)
        + _mul32(iz.to(torch.int64) & MASK32, 0xCB1AB31F)
        + _mul32(iw.to(torch.int64) & MASK32, 0x165667B1)
        + (seed & MASK32)
    ) & MASK32
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    return h ^ (h >> 15)


def _grad_dot(ix, iy, iz, iw, fx, fy, fz, fw, seed: int):
    """The gradient the hash selects (components in {-1, 0, 1}) dotted with
    the offset vector."""
    h = _hash4(ix, iy, iz, iw, seed)
    gx = (h & 3).to(torch.float32) - 1.0
    gy = ((h >> 2) & 3).to(torch.float32) - 1.0
    gz = ((h >> 4) & 3).to(torch.float32) - 1.0
    gw = ((h >> 6) & 3).to(torch.float32) - 1.0
    return gx * fx + gy * fy + gz * fz + gw * fw


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def gradient_noise_4d(x, y, z, w, seed: int = 0):
    """Perlin-style 4D gradient noise in about [-1, 1]; the coordinates are
    float32 tensors that broadcast."""
    ix, iy, iz, iw = (torch.floor(c).to(torch.int32) for c in (x, y, z, w))
    fx, fy, fz, fw = x - ix.to(torch.float32), y - iy.to(torch.float32), z - iz.to(torch.float32), \
        w - iw.to(torch.float32)
    ux, uy, uz, uw = _fade(fx), _fade(fy), _fade(fz), _fade(fw)
    ix, iy, iz, iw = (c.to(torch.int64) for c in (ix, iy, iz, iw))

    def corner(dx, dy, dz, dw):
        return _grad_dot(ix + dx, iy + dy, iz + dz, iw + dw, fx - dx, fy - dy, fz - dz, fw - dw, seed)

    def lerp(a, b, t):
        return a + (b - a) * t

    vals_w = []
    for dw in (0, 1):
        vals_z = []
        for dz in (0, 1):
            v00 = lerp(corner(0, 0, dz, dw), corner(1, 0, dz, dw), ux)
            v01 = lerp(corner(0, 1, dz, dw), corner(1, 1, dz, dw), ux)
            vals_z.append(lerp(v00, v01, uy))
        vals_w.append(lerp(vals_z[0], vals_z[1], uz))
    return lerp(vals_w[0], vals_w[1], uw) * 0.5


def ridged_multi_4d(
    x, y, z, w,
    octaves: int = DEFAULT_OCTAVES,
    lacunarity: float = DEFAULT_LACUNARITY,
    persistence: float = DEFAULT_PERSISTENCE,
    attenuation: float = DEFAULT_ATTENUATION,
    seed: int = 0,
):
    """Ridged multifractal accumulation (the noise crate's RidgedMulti): per
    octave signal = (1 - |noise|)^2 * weight, weight = clamp(signal *
    attenuation, 0, 1); the sum scaled into about [-1, 1]."""
    result = torch.zeros(torch.broadcast_shapes(x.shape, y.shape, z.shape, w.shape), dtype=torch.float32,
                         device=x.device)
    weight = torch.ones_like(result)
    freq = 1.0
    amp = 1.0
    for o in range(octaves):
        n = gradient_noise_4d(x * freq, y * freq, z * freq, w * freq, seed + o)
        s = 1.0 - n.abs()
        signal = s * s * weight
        weight = torch.clamp(signal * attenuation, 0.0, 1.0)
        result = result + signal * amp
        freq *= lacunarity
        amp *= persistence
    return result * (2.0 / octaves) - 1.0


def apply_noise(cloud, scale: float = 1.0, seed: int = 0):
    """NoiseMaterial: every SH coefficient replaced by ridged noise at
    (position * scale, coefficient index) (noise.rs:40-55), on the cloud's
    device."""
    pos = cloud.position.to(torch.float32) * scale
    k = cloud.spherical_harmonic.shape[1]
    ws = torch.arange(k, dtype=torch.float32, device=pos.device)
    sh = ridged_multi_4d(pos[:, 0:1], pos[:, 1:2], pos[:, 2:3], ws[None, :], seed=seed)
    return dataclasses.replace(cloud, spherical_harmonic=sh)
