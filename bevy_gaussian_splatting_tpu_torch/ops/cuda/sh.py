"""The projection's SH colour stage as one autograd function: a hand-written
forward and backward (``csrc/sh.cu``) on the card, their plain versions on
the CPU.

Replaces no TPU kernel: the JAX package leaves ``ops/sh.py`` to XLA, which
fuses the stage and its gradient.  Run eagerly with autograd, the stage's
loop over the coefficients (``sh.py`` ``_interleaved_contract``) gives each
slice of ``sh`` a zero-filled gradient as wide as all of ``sh`` and adds
them up: 16 such in 3D, 48 in 4D, where at 1M gaussians they made most of
a training step.  :func:`sh_colour` computes the same colour, 0.5 + sum_j
F_j sh[3j:3j+3], with the basis F of ``sh.py`` ``sh_basis`` (3D, 2DGS:
through degree min(storage degree, 3)) or of
``spherindrical_harmonics_lookup`` (4D: degree 3 times the harmonics
cos(2 pi b dir_t / duration), b = 0..2), and its backward by hand:

    d_sh[3j + c] = F_j g_c            (0 in padding and unevaluated columns)
    dF_j = sum_c g_c sh[3j + c]
    4D, F_{16b+i} = Y_i T_b: dY_i = sum_b dF_{16b+i} T_b,
        dT_b = sum_i dF_{16b+i} Y_i,
        d_dir_t = sum_{b>=1} dT_b (-sin(2 pi b theta)) 2 pi b / duration
    d_dir from the derivatives of sh_basis's polynomials.

``d_sh`` is autograd's bits (the same product; where more than one
coefficient is summed, autograd's sum of zero-filled slices makes a -0
+0, and so do both versions); the forward is the eager chain's bits.

Dispatch by what the input shows: CUDA tensors launch the kernels (float32,
or raise), CPU tensors run the plain versions (the eager chain under
no_grad, and the same backward written in PyTorch).  The counter
``sh.fused`` (``utils/trace.py``) counts forward launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from bevy_gaussian_splatting_tpu_torch.ops import sh as sh_ops
from bevy_gaussian_splatting_tpu_torch.ops.cuda import build
from bevy_gaussian_splatting_tpu_torch.utils import trace

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
_KIND_4D = 4  # csrc/sh.cu's kind of a 4D row; 0-3 a 3D row's evaluated degree
HARMONICS = 3  # 4D: cos(2 pi b theta), b = 0..2 (spherindrical_harmonics_lookup's degree_time 2)


def evaluated_degree(sh: torch.Tensor) -> int:
    """The degree ``spherical_harmonics_lookup`` evaluates a 3D row of
    ``sh``'s width through: its storage degree, at most 3."""
    return min(sh_ops.sh_storage_degree(sh), 3)


def _basis(direction, dir_t, duration, degree):
    """F [N, K], the basis the colour contracts, with Y [N, (degree + 1)^2]
    and, in 4D, the harmonics T [N, 3] and the arguments 2 pi b theta of
    T_1, T_2 (None in 3D), each as ``ops/sh.py`` computes it."""
    y = sh_ops.sh_basis(direction, degree)
    if dir_t is None:
        return y, y, None, None
    theta = dir_t / duration
    args = [2.0 * math.pi * b * theta for b in range(1, HARMONICS)]
    t = torch.stack([torch.ones_like(theta)] + [torch.cos(a) for a in args], dim=-1)
    f = (y[..., None, :] * t[..., :, None]).reshape(*y.shape[:-1], HARMONICS * y.shape[-1])
    return f, y, t, args


def _basis_grad(direction: torch.Tensor, d_y: torch.Tensor, degree: int) -> torch.Tensor:
    """d_dir [N, 3] of ``sh_basis(direction, degree)`` (degree <= 3) from
    d_y, the gradient of each of its columns."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    c = sh_ops._SHC
    zero = torch.zeros_like(x)
    dx, dy, dz = zero, zero, zero
    if degree >= 1:
        dy = dy + c[1] * d_y[..., 1]
        dz = dz + c[2] * d_y[..., 2]
        dx = dx + c[3] * d_y[..., 3]
    if degree >= 2:
        e4, e5, e6, e7, e8 = (c[k] * d_y[..., k] for k in range(4, 9))
        dx = dx + e4 * y + e7 * z + (e8 - e6) * (2.0 * x)
        dy = dy + e4 * x + e5 * z - (e6 + e8) * (2.0 * y)
        dz = dz + e5 * y + e7 * x + e6 * (4.0 * z)
    if degree >= 3:
        xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
        e9, e10, e11, e12, e13, e14, e15 = (c[k] * d_y[..., k] for k in range(9, 16))
        dx = dx + (e9 * (6.0 * xy) + e10 * yz - e11 * (2.0 * xy) - e12 * (6.0 * xz)
                   + e13 * (4.0 * zz - 3.0 * xx - yy) + e14 * (2.0 * xz) + e15 * (3.0 * (xx - yy)))
        dy = dy + (e9 * (3.0 * (xx - yy)) + e10 * xz + e11 * (4.0 * zz - xx - 3.0 * yy) - e12 * (6.0 * yz)
                   - e13 * (2.0 * xy) - e14 * (2.0 * yz) - e15 * (6.0 * xy))
        dz = dz + (e10 * xy + e11 * (8.0 * yz) + e12 * (6.0 * zz - 3.0 * (xx + yy)) + e13 * (8.0 * xz)
                   + e14 * (xx - yy))
    return torch.stack([dx, dy, dz], dim=-1)


def sh_colour_plain(direction, sh, dir_t=None, duration=None) -> torch.Tensor:
    """Plain forward: the eager chain (``ops/sh.py``)."""
    if dir_t is None:
        return sh_ops.spherical_harmonics_lookup(direction, sh)
    return sh_ops.spherindrical_harmonics_lookup(direction, dir_t, sh, duration)


def sh_colour_backward_plain(direction, sh, dir_t, duration, grad) -> tuple:
    """Plain backward: (d_dir [N, 3], d_sh like ``sh``, d_dir_t [N] or None)
    of :func:`sh_colour_plain` at ``grad`` = d_rgb [N, 3], by the formula
    above."""
    degree = evaluated_degree(sh) if dir_t is None else 3
    f, y, t, args = _basis(direction, dir_t, duration, degree)
    k = f.shape[-1]
    prod = (f[..., :, None] * grad[..., None, :]).reshape(*f.shape[:-1], 3 * k)
    d_sh = torch.zeros_like(sh)
    if k == 1:
        d_sh[..., :3] = prod  # one slice: autograd's copy into zeros keeps a -0
    else:
        d_sh[..., : 3 * k] += prod  # autograd's sum of zero-filled slices makes a -0 +0
    d_f = (grad[..., None, :] * sh[..., : 3 * k].reshape(*f.shape, 3)).sum(-1)
    if dir_t is None:
        return _basis_grad(direction, d_f, degree), d_sh, None
    d_f = d_f.reshape(*f.shape[:-1], HARMONICS, y.shape[-1])
    d_y = (d_f * t[..., :, None]).sum(-2)
    d_t = (d_f * y[..., None, :]).sum(-1)
    # d cos(a) / da = -sin(a), a = 2 pi b theta
    d_theta = sum(d_t[..., b] * -torch.sin(args[b - 1]) * (2.0 * math.pi * b) for b in range(1, HARMONICS))
    return _basis_grad(direction, d_y, degree), d_sh, d_theta / duration


def _ready(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise ValueError(f"the SH kernels take float32, {name} is {t.dtype}")
    return t.contiguous()


def _launch_args(direction, sh, dir_t, duration):
    """The kernels' inputs, checked: (kind, direction, sh, dir_t, duration)."""
    dev = sh.device
    if any(t is not None and t.device != dev for t in (direction, dir_t, duration)):
        raise ValueError("the SH colour's inputs lie on different devices")
    sh = _ready(sh, "sh")
    if sh.data_ptr() % 16:
        sh = sh.clone()
    kind = _KIND_4D if dir_t is not None else evaluated_degree(sh)
    if dir_t is not None:
        dir_t, duration = _ready(dir_t, "dir_t"), _ready(duration, "duration")
    return kind, _ready(direction, "direction"), sh, dir_t, duration


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fn(name: str, argtypes):
    fn = getattr(build.load("sh"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def sh_colour_forward_kernel(direction, sh, dir_t=None, duration=None) -> torch.Tensor:
    """rgb [N, 3] by ``csrc/sh.cu``'s forward: CUDA tensors."""
    kind, direction, sh, dir_t, duration = _launch_args(direction, sh, dir_t, duration)
    n = sh.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=sh.device)
    with torch.cuda.device(sh.device):
        status = _fn("bgs_sh_forward", _FWD_ARGTYPES)(
            _ptr(direction), _ptr(dir_t), _ptr(duration), _ptr(sh), n, sh.shape[1], kind, rgb.data_ptr(),
            torch.cuda.current_stream(sh.device).cuda_stream,
        )
    build.check(status, "sh_colour forward")
    if n > 0:
        trace.count("sh.fused")
    return rgb


def sh_colour_backward_kernel(direction, sh, dir_t, duration, grad) -> tuple:
    """(d_dir, d_sh, d_dir_t or None) by ``csrc/sh.cu``'s backward: CUDA
    tensors."""
    kind, direction, sh, dir_t, duration = _launch_args(direction, sh, dir_t, duration)
    grad = _ready(grad, "grad")
    n = sh.shape[0]
    d_sh = torch.empty_like(sh)
    d_dir = torch.empty((n, 3), dtype=torch.float32, device=sh.device)
    d_dir_t = None if dir_t is None else torch.empty((n,), dtype=torch.float32, device=sh.device)
    with torch.cuda.device(sh.device):
        status = _fn("bgs_sh_backward", _BWD_ARGTYPES)(
            _ptr(direction), _ptr(dir_t), _ptr(duration), _ptr(sh), _ptr(grad), n, sh.shape[1], kind,
            d_sh.data_ptr(), d_dir.data_ptr(), _ptr(d_dir_t),
            torch.cuda.current_stream(sh.device).cuda_stream,
        )
    build.check(status, "sh_colour backward")
    return d_dir, d_sh, d_dir_t


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


class ShColour(torch.autograd.Function):
    """rgb [N, 3] from direction [N, 3] and sh [N, W] (3D), or with dir_t
    [N] and duration (a float32 scalar tensor) in 4D."""

    @staticmethod
    def forward(ctx, direction, sh, dir_t, duration):
        ctx.save_for_backward(direction, sh, dir_t, duration)
        if _on(sh) == "cuda":
            return sh_colour_forward_kernel(direction, sh, dir_t, duration)
        return sh_colour_plain(direction, sh, dir_t, duration)

    @staticmethod
    def backward(ctx, grad):
        direction, sh, dir_t, duration = ctx.saved_tensors
        if _on(sh) == "cuda":
            d_dir, d_sh, d_dir_t = sh_colour_backward_kernel(direction, sh, dir_t, duration, grad)
        else:
            d_dir, d_sh, d_dir_t = sh_colour_backward_plain(direction, sh, dir_t, duration, grad)
        need = ctx.needs_input_grad
        # degree 0 reads no direction: no gradient, as the eager chain
        uses_dir = dir_t is not None or evaluated_degree(sh) > 0
        return (d_dir if need[0] and uses_dir else None, d_sh if need[1] else None,
                d_dir_t if dir_t is not None and need[2] else None, None)


def sh_colour(direction: torch.Tensor, sh: torch.Tensor, dir_t: Optional[torch.Tensor] = None,
              duration: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The projection's colour stage: ``spherical_harmonics_lookup(direction,
    sh)`` (3D, 2DGS), or with ``dir_t`` and ``duration``
    ``spherindrical_harmonics_lookup(direction, dir_t, sh, duration)`` (4D,
    a [N, 144] row), the same bits, differentiable by the hand-derived
    backward."""
    return ShColour.apply(direction, sh, dir_t, duration)
