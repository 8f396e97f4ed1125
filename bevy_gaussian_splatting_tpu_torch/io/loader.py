"""Asset loading by extension (reference: src/io/loader.rs:17-116), the JAX
package's ``io/loader.py`` with a ``device`` for what it loads:

  .ply            -> 3D cloud (PLY parse and activations)
  .gcloud         -> 3D cloud: FlexBuffers, bincode2 (gzip magic) or the
                     precomputed-covariance schema
  .ply4d          -> 4D cloud
  .gc4d           -> 4D cloud: FlexBuffers or bincode2
  .npz            -> any cloud class (columnar)
  .gltf / .glb    -> KHR_gaussian_splatting scene (io/scene.py)

A loaded cloud's tensors are made on ``device`` from the decoded host
arrays, so it goes into ``render()`` or an ``InteractiveRenderer`` on that
device without another copy.  ``.ply``, ``.gcloud`` and ``.gc4d`` are read
and written by the native runtime (``native/``) at the codecs' defaults, as
in the JAX package's loader.
"""

from __future__ import annotations

import base64
import hashlib
import os
import urllib.request
from typing import Union

from bevy_gaussian_splatting_tpu_torch.device import DeviceLike
from bevy_gaussian_splatting_tpu_torch.io import bincode2
from bevy_gaussian_splatting_tpu_torch.io import gcloud as gcloud_codec
from bevy_gaussian_splatting_tpu_torch.io import ply as ply_codec
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    Gaussian3dCloud,
    Gaussian3dCovCloud,
    Gaussian4dCloud,
)

GZIP_MAGIC = b"\x1f\x8b"


def resolve_input(input_file: str) -> str:
    """A CLI or viewer input string -> a path or URI, as the reference's
    parse_input_file (viewer/viewer.rs:84-105): url-safe base64 of a utf-8
    URI first, then percent-decoding, else the string as it is."""
    try:
        return base64.b64decode(input_file.encode("ascii"), altchars=b"-_", validate=True).decode("utf-8")
    except ValueError:  # binascii.Error and the unicode errors are ValueErrors
        pass
    decoded = _percent_decode(input_file)
    return input_file if decoded is None else decoded


def _percent_decode(value: str) -> Union[str, None]:
    """decode_percent_encoded (viewer/viewer.rs:108-137): None when the string
    holds no %XX escape or a malformed one."""
    out = bytearray()
    data = value.encode("utf-8")
    i = 0
    changed = False
    while i < len(data):
        if data[i:i + 1] == b"%":
            if i + 2 >= len(data):
                return None
            try:
                out.append(int(data[i + 1:i + 3].decode("ascii"), 16))
            except ValueError:
                return None
            i += 3
            changed = True
        else:
            out.append(data[i])
            i += 1
    if not changed:
        return None
    try:
        return out.decode("utf-8")
    except UnicodeDecodeError:
        return None


def is_url(path: str) -> bool:
    return path.startswith("http://") or path.startswith("https://")


def fetch_bytes(url: str, cache_dir: Union[str, None] = None, timeout: float = 60.0) -> bytes:
    """A remote asset (the reference's bevy web_asset layer).  With
    ``cache_dir`` (or $BGS_ASSET_CACHE) responses are kept on disk by a hash
    of the URL and read from there again (tests/headless_examples.rs:243-292)."""
    cache_dir = cache_dir or os.environ.get("BGS_ASSET_CACHE")
    cache_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        key = hashlib.sha256(url.encode()).hexdigest()[:24]
        cache_path = os.path.join(cache_dir, key + os.path.splitext(url.split("?")[0])[1])
        if os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                return f.read()
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        data = resp.read()
    if cache_path:
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, cache_path)
    return data


def _read_source(path: str) -> tuple[bytes, str]:
    """(bytes, extension) of a local path or an http(s) URL."""
    if is_url(path):
        return fetch_bytes(path), os.path.splitext(path.split("?")[0])[1].lower()
    with open(path, "rb") as f:
        return f.read(), os.path.splitext(path)[1].lower()


def load_cloud(path: str, device: DeviceLike = None) -> Union[Gaussian3dCloud, Gaussian4dCloud, Gaussian3dCovCloud]:
    data, ext = _read_source(path)
    if ext == ".ply":
        return ply_codec.parse_ply_3d(data, device=device)
    if ext == ".ply4d":
        return ply_codec.parse_ply_4d(data, device=device)
    if ext == ".gcloud":
        # bincode2 is gzip-wrapped; FlexBuffers is the default codec
        # (src/io/gcloud/mod.rs); the precompute_covariance_3d flavour has
        # a packed covariance column (planar_3d.rs:76-85)
        if data[:2] == GZIP_MAGIC:
            return bincode2.decode_bincode_3d(data, device)
        if gcloud_codec.gcloud_is_cov3d(data):
            return gcloud_codec.decode_gcloud_cov3d(data, device)
        return gcloud_codec.decode_gcloud_3d(data, device)
    if ext == ".gc4d":
        if data[:2] == GZIP_MAGIC:
            return bincode2.decode_bincode_4d(data, device)
        return gcloud_codec.decode_gcloud_4d(data, device)
    if ext == ".npz":
        return gcloud_codec.decode_npz(data, device)
    raise ValueError(f"unsupported cloud extension {ext!r} for {path}")


def load_scene(path: str, device: DeviceLike = None):
    """A KHR_gaussian_splatting glTF / GLB scene (src/io/scene.rs:206-226)."""
    from bevy_gaussian_splatting_tpu_torch.io.scene import load_khr_gaussian_scene

    return load_khr_gaussian_scene(fetch_bytes(path) if is_url(path) else path, device=device)


def load_any(path: str, device: DeviceLike = None):
    """A cloud, or a ``GaussianScene`` for ``.gltf`` / ``.glb``, from a local
    path, an http(s) URL or the base64 or percent-encoded form of either
    (viewer/viewer.rs:84-137 and bevy web_asset)."""
    path = resolve_input(path)
    ext = os.path.splitext(path.split("?")[0] if is_url(path) else path)[1].lower()
    if ext in (".gltf", ".glb"):
        return load_scene(path, device)
    return load_cloud(path, device)


def save_cloud(cloud, path: str, codec: str = "flexbuffers") -> int:
    """CloudCodec::write_to_file (src/io/codec.rs:8-17) -> bytes written.
    ``codec``: "flexbuffers" (default) or "bincode2" (gzip, the same
    extensions, told apart on load).  ``.ply4d`` (``ply.write_ply_4d``) has
    no counterpart in the JAX package."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gcloud":
        if isinstance(cloud, Gaussian3dCovCloud):
            if codec == "bincode2":
                raise ValueError("precomputed-covariance clouds use the flexbuffers codec")
            data = gcloud_codec.encode_gcloud_cov3d(cloud)
        elif not isinstance(cloud, Gaussian3dCloud):
            raise ValueError(".gcloud stores 3D clouds")
        elif codec == "bincode2":
            data = bincode2.encode_bincode_3d(cloud)
        else:
            data = gcloud_codec.encode_gcloud_3d(cloud)
    elif ext == ".gc4d":
        if not isinstance(cloud, Gaussian4dCloud):
            raise ValueError(".gc4d stores 4D clouds")
        data = bincode2.encode_bincode_4d(cloud) if codec == "bincode2" else gcloud_codec.encode_gcloud_4d(cloud)
    elif ext == ".ply":
        data = ply_codec.write_ply_3d(cloud)
    elif ext == ".ply4d":
        if not isinstance(cloud, Gaussian4dCloud):
            raise ValueError(".ply4d stores 4D clouds")
        data = ply_codec.write_ply_4d(cloud)
    elif ext == ".npz":
        data = gcloud_codec.encode_npz(cloud)
    else:
        raise ValueError(f"unsupported cloud extension {ext!r} for {path}")
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
