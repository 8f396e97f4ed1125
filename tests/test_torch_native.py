"""The port's native host runtime (bevy_gaussian_splatting_tpu_torch/native/)
against the JAX package's (bevy_gaussian_splatting_tpu/native/): the same C++
arithmetic from the port's own copy of the source, built with the same
compiler flags, so PLY decodes are array-equal, ``.gcloud`` / ``.gc4d``
encodes byte-equal and decodes array-equal, and the radix sort is a stable
argsort.  Also: which PLY layouts go to the numpy decoder (by
``parse_ply_3d.paths``), that a failed build or load raises, concurrent
builds and decodes, and the two functions ported beside it
(``ops/sh.py`` ``linear_to_srgb``, ``ops/gaussian_2d.py``
``surfel_fragment_power``).  CPU only; ``g++`` builds both libraries.
"""

import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_cases as cases
from bevy_gaussian_splatting_tpu import native as jnative
from bevy_gaussian_splatting_tpu.io import gcloud as jgc
from bevy_gaussian_splatting_tpu.io import ply as jply
from bevy_gaussian_splatting_tpu_torch import native
from bevy_gaussian_splatting_tpu_torch.io import gcloud as tgc
from bevy_gaussian_splatting_tpu_torch.io import ply as tply
from bevy_gaussian_splatting_tpu_torch.models.cloud import (
    cloud_from_numpy,
    num_sh_coefficients,
    random_arrays_3d_seeded,
    random_arrays_4d_seeded,
    sh_coeff_width,
)
from test_torch_io import PLY_CASES, assert_same, ply_bytes

ROOT = Path(__file__).resolve().parents[1]
FIELDS_3D = ("pv", "sh", "rot", "so")
FIELDS_4D = ("pv", "sh", "iso", "so", "ts")


def assert_arrays_equal(got, want, names):
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype == np.float32 and g.flags.c_contiguous, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The cases compare against the JAX package's native library, whose
    loader keeps ``None`` for good when its build or load fails: without
    the library every case fails here, for that one reason (the root
    ``conftest.py`` builds it before xdist's workers start)."""
    if not jnative.available():
        built = sorted(p.name for p in (ROOT / "bevy_gaussian_splatting_tpu" / "native").glob("_gsplat_native_*"))
        pytest.fail(f"the JAX package's native library did not load: its loader keeps no error; "
                    f"files built beside its source: {built or 'none'}", pytrace=False)


def sh_layout(data: bytes, kw: dict) -> dict:
    """The SH width and per-channel count both parse_ply_3d's pass (an
    explicit degree, else the header's f_rest count)."""
    degree = kw.get("sh_degree")
    if degree is None:
        degree = tply._infer_sh_degree_from_rest(tply._header_rest_count(data))
    return {"sh_width": sh_coeff_width(degree), "sh_per_channel": num_sh_coefficients(degree)}


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

BINARY_CASES = [c for c in PLY_CASES if c[1].get("fmt", "binary") == "binary" and "strict_reference" not in c[2]]


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "loose"])
@pytest.mark.parametrize("make,kw", [c[1:] for c in BINARY_CASES], ids=[c[0] for c in BINARY_CASES])
def test_ply_decode_matches_jax(make, kw, strict):
    """Array-equal to JAX's native decode in every binary case of
    ``tests/test_torch_io.py``, with the reference's f_rest quirk and
    without; 1..32 padding rows, the last 32 on a multiple of 32."""
    data, _ = ply_bytes(**make)
    layout = sh_layout(data, kw)
    got = native.parse_ply_3d_native(data, strict, **layout)
    want = jnative.parse_ply_3d_native(data, strict, **layout)
    assert_arrays_equal(got, want, FIELDS_3D)
    n = make.get("n", 6)
    assert len(got[0]) == n + 32 - n % 32 and got[1].shape[1] == layout["sh_width"]
    assert not got[0][n:].any() and not got[2][n:].any()


def test_ply_decode_threads_match_jax():
    """12,000 rows (threaded from 4,096): 1 thread against 8 in each package,
    and the packages against each other; a bytearray decodes in place."""
    data, _ = ply_bytes(n=12_000, seed=5)
    layout = sh_layout(data, {})
    one = native.parse_ply_3d_native(data, n_threads=1, **layout)
    eight = native.parse_ply_3d_native(bytearray(data), n_threads=8, **layout)
    assert_arrays_equal(eight, one, FIELDS_3D)
    assert_arrays_equal(one, jnative.parse_ply_3d_native(data, n_threads=8, **layout), FIELDS_3D)
    assert_arrays_equal(one, jnative.parse_ply_3d_native(data, n_threads=1, **layout), FIELDS_3D)


def _big_endian(data: bytes) -> bytes:
    head, body = data.split(b"end_header\n", 1)
    swapped = np.frombuffer(body, "<f4").astype(">f4").tobytes()
    return head.replace(b"binary_little_endian", b"binary_big_endian") + b"end_header\n" + swapped


def _list_property(data: bytes) -> bytes:
    return data.replace(b"property float x\n", b"property list uchar int idx\nproperty float x\n")


def _zero_rows(data: bytes) -> bytes:
    head = data.split(b"end_header\n", 1)[0]
    return head.replace(b"element vertex 6", b"element vertex 0") + b"end_header\n"


# (id, transform of ply_bytes(), the native status that refuses it)
DISPATCH_CASES = [
    ("ascii", lambda d: ply_bytes(fmt="ascii")[0], -1),
    ("big-endian", _big_endian, -1),
    ("list-property", _list_property, -1),
    ("zero-rows", _zero_rows, -1),
    ("missing-property", lambda d: d.replace(b"property float rot_3\n", b"property float qq_3\n"), -2),
    ("truncated", lambda d: d[:-40], -3),
]


@pytest.mark.parametrize("make,status", [c[1:] for c in DISPATCH_CASES], ids=[c[0] for c in DISPATCH_CASES])
def test_ply_dispatch_matches_jax(make, status):
    """A layout or content the native reader refuses by its status goes to
    the numpy decoder (counted), which decodes or raises as JAX's default
    path does; the native reader's status is the one expected."""
    data = make(ply_bytes()[0])
    lib = native.load()
    out = np.zeros((64, 48), np.float32)
    ptr = out.ctypes.data_as(native._F32)
    count = lib.ply3d_count(data, len(data))
    got_status = count if count < 0 else lib.ply3d_parse(data, len(data), ptr, ptr, ptr, ptr, 1, 1, 48, 16)
    assert got_status == status
    assert native.parse_ply_3d_native(data) is None
    before = dict(tply.parse_ply_3d.paths)
    try:
        want = jply.parse_ply_3d(data)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            tply.parse_ply_3d(data, device="cpu")
    else:
        assert_same(want, tply.parse_ply_3d(data, device="cpu"))
    assert tply.parse_ply_3d.paths == {"native": before["native"], "numpy": before["numpy"] + 1}


# ---------------------------------------------------------------------------
# .gcloud / .gc4d
# ---------------------------------------------------------------------------

GCLOUD_KINDS = [f"3d-sh{d}" for d in range(5)] + ["4d"]


def gcloud_arrays(kind: str, n: int = 96) -> tuple:
    if kind == "4d":
        a = random_arrays_4d_seeded(n, seed=31)
        names = ("position_visibility", "spherindrical_harmonic", "isotropic_rotations", "scale_opacity",
                 "timestamp_timescale")
    else:
        a = random_arrays_3d_seeded(n, seed=30, sh_degree=int(kind[-1]))
        names = ("position_visibility", "spherical_harmonic", "rotation", "scale_opacity")
    return a, [a[k] for k in names]


@pytest.mark.parametrize("kind", GCLOUD_KINDS)
def test_gcloud_codec_matches_jax(kind):
    """Encode byte-equal to JAX's native encoder (3D at SH widths
    4/12/28/48/76, and 4D); decode array-equal, both ways round."""
    a, cols = gcloud_arrays(kind)
    is4d = kind == "4d"
    encode, jencode = ((native.encode_gcloud_4d_native, jnative.encode_gcloud_4d_native) if is4d else
                       (native.encode_gcloud_3d_native, jnative.encode_gcloud_3d_native))
    data = encode(*cols)
    assert data == jencode(*cols)
    got, want = native.decode_gcloud_native(data), jnative.decode_gcloud_native(data)
    assert got["is4d"] is want["is4d"] is is4d
    names = FIELDS_4D if is4d else FIELDS_3D
    assert_arrays_equal([got[k] for k in names], [want[k] for k in names], names)
    assert_arrays_equal([got[k] for k in names], cols, names)
    if not is4d:
        assert got["sh"].shape[1] == sh_coeff_width(int(kind[-1]))
    bad = list(cols)
    bad[2] = bad[2][:-1]  # a field one row short: the encoder would read past it
    with pytest.raises(ValueError):
        encode(*bad)


@pytest.mark.parametrize("writer", ["port-flexbuffers", "jax-builder"])
@pytest.mark.parametrize("kind", ["3d-sh3", "3d-sh1", "4d"])
def test_gcloud_native_decodes_other_layouts(kind, writer):
    """The native decoder reads the port's own FlexBuffers writer (4D: key
    strings in another order) and the flatbuffers Builder's layout (widths
    per vector) array-equal to the arrays written."""
    a, cols = gcloud_arrays(kind, n=40)
    is4d = kind == "4d"
    if writer == "port-flexbuffers":
        cloud = cloud_from_numpy(a, "cpu")
        data = (tgc.encode_gcloud_4d if is4d else tgc.encode_gcloud_3d)(cloud, use_native=False)
    else:
        jc = cases.jax_cloud(a)
        data = (jgc.encode_gcloud_4d if is4d else jgc.encode_gcloud_3d)(jc, use_native=False)
    got = native.decode_gcloud_native(data)
    names = FIELDS_4D if is4d else FIELDS_3D
    assert_arrays_equal([got[k] for k in names], cols, names)


def test_gcloud_native_refuses_malformed_buffers():
    """Every truncation and a sample of byte flips of a 3D file either decode
    to the written arrays, are refused by the probe (None), or raise
    ``ValueError``: the reader checks each offset against the buffer, so
    none reads outside it."""
    _, cols = gcloud_arrays("3d-sh1", n=8)
    data = native.encode_gcloud_3d_native(*cols)
    rng = np.random.default_rng(3)
    bad = [data[:k] for k in range(len(data))]
    for pos in rng.integers(0, len(data), 300):
        flipped = bytearray(data)
        flipped[pos] ^= int(rng.integers(1, 256))
        bad.append(bytes(flipped))
    outcomes = {"none": 0, "raised": 0, "decoded": 0}
    for buf in bad:
        try:
            got = native.decode_gcloud_native(buf)
        except ValueError:
            outcomes["raised"] += 1
            continue
        outcomes["none" if got is None else "decoded"] += 1
    assert outcomes["none"] > 0 and outcomes["raised"] > 0, outcomes
    assert native.decode_gcloud_native(b"") is None and native.decode_gcloud_native(b"\x01\x02") is None


# ---------------------------------------------------------------------------
# Radix sort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 4_095, 4_096, 100_000])
def test_radix_sort_matches_jax_and_argsort(n):
    """Stable: duplicate keys keep their values' order.  Sorted in place."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(n // 8, 2), n, dtype=np.uint32)  # many duplicates
    keys[: n // 4] = rng.integers(0, 2**32, n // 4, dtype=np.uint64).astype(np.uint32)  # and full-range keys
    values = np.arange(n, dtype=np.uint32)
    order = np.argsort(keys, kind="stable")
    k, v = keys.copy(), values.copy()
    got = native.radix_sort_pairs(k, v)
    assert got[0] is k and got[1] is v
    want = jnative.radix_sort_pairs(keys.copy(), values.copy())
    for g, w, ref in zip(got, want, (keys[order], values[order])):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, ref)
    with pytest.raises(ValueError):
        native.radix_sort_pairs(keys, values[:-1] if n else np.zeros(1, np.uint32))


# ---------------------------------------------------------------------------
# Build, load and threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["missing-compiler", "failed-build", "failed-load"])
def test_build_failure_raises(fault, tmp_path, monkeypatch):
    """No silent fallback: a compiler that does not exist, a source that does
    not compile and a library that does not load each raise
    ``NativeBuildError``, from ``load()`` and from the default PLY path."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    if fault == "missing-compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    elif fault == "failed-build":
        broken = tmp_path / "broken.cpp"
        broken.write_text('extern "C" int ply3d_count( {\n')
        monkeypatch.setattr(native, "SOURCE", broken)
    else:
        path = native.library_path()
        path.parent.mkdir(parents=True)
        path.write_bytes(b"not a shared library")
    with pytest.raises(native.NativeBuildError):
        native.load()
    with pytest.raises(native.NativeBuildError):
        tply.parse_ply_3d(ply_bytes()[0], device="cpu")
    assert not list(tmp_path.rglob("*.tmp.so"))


def test_concurrent_builds(tmp_path, monkeypatch):
    """Two processes and four threads build into one empty directory at once:
    one library, no temporary left, every caller loaded."""
    build_dir = tmp_path / "build"
    script = (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]); "
        "from bevy_gaussian_splatting_tpu_torch import native; native.BUILD_DIR = Path(sys.argv[2]); "
        "print(native.load()._name)"
    )
    procs = [subprocess.Popen([sys.executable, "-c", script, str(ROOT), str(build_dir)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(2)]
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_LIB", None)
    libs, errors = [], []

    def first_call():
        try:
            libs.append(native.load())
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=first_call) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = [p.communicate(timeout=120) for p in procs]
    assert not errors and len(libs) == 4 and all(lib is libs[0] for lib in libs)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()
        assert out.decode().strip() == libs[0]._name
    assert [p.name for p in build_dir.iterdir()] == [Path(libs[0]._name).name]


def test_threads_decode_at_once():
    """Eight threads decode PLY and ``.gcloud`` bytes at once, as the stream
    loader thread beside the interpreter does: each result is the
    one-thread result."""
    data, _ = ply_bytes(n=5_000, seed=8)
    layout = sh_layout(data, {})
    _, cols = gcloud_arrays("3d-sh3", n=2_000)
    blob = native.encode_gcloud_3d_native(*cols)
    want_ply = native.parse_ply_3d_native(data, n_threads=1, **layout)
    results = [None] * 8

    def work(i):
        if i % 2:
            results[i] = native.parse_ply_3d_native(data, n_threads=2, **layout)
        else:
            d = native.decode_gcloud_native(blob)
            results[i] = tuple(d[k] for k in FIELDS_3D)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, got in enumerate(results):
        assert_arrays_equal(got, want_ply if i % 2 else cols, FIELDS_3D)


# ---------------------------------------------------------------------------
# linear_to_srgb, surfel_fragment_power
# ---------------------------------------------------------------------------


def test_linear_to_srgb_matches_jax():
    """Both branches and the knee against the JAX function: the linear branch
    bit for bit, the power branch within 2.4e-7 (two ulps at 1; XLA's pow
    and torch's differ by one ulp in 70 of 5,130 values); and the inverse of
    ``srgb_to_linear`` within 1e-6 on [0, 1]."""
    from bevy_gaussian_splatting_tpu.ops.sh import linear_to_srgb as jax_linear_to_srgb
    from bevy_gaussian_splatting_tpu_torch.ops.sh import linear_to_srgb, srgb_to_linear

    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(0, 1, 4096), rng.uniform(0, 0.01, 1024),
                        [0.0, 0.0031308, np.nextafter(np.float32(0.0031308), np.float32(1)), 1.0, -0.5, 2.0]])
    x = x.astype(np.float32)
    got = linear_to_srgb(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_linear_to_srgb(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    low = x <= 0.0031308
    np.testing.assert_array_equal(got[low], want[low])
    back = srgb_to_linear(torch.from_numpy(got)).numpy()
    inside = (x >= 0) & (x <= 1)
    np.testing.assert_allclose(back[inside], x[inside], rtol=0, atol=1e-6)


def test_surfel_fragment_power_matches_jax():
    """Seeded homographies, pixels and means, the ``pz`` clamp included,
    against the JAX function."""
    from bevy_gaussian_splatting_tpu.ops.gaussian_2d import surfel_fragment_power as jax_power
    from bevy_gaussian_splatting_tpu_torch.ops.gaussian_2d import surfel_fragment_power

    rng = np.random.default_rng(6)
    n = 2048
    t = rng.normal(size=(n, 3, 3)).astype(np.float32)
    t[:, 2, :] = np.abs(t[:, 2, :]) + 0.5
    pix = rng.uniform(0, 64, (n, 2)).astype(np.float32)
    mean = (pix + rng.normal(0, 3, (n, 2))).astype(np.float32)
    t[0] = np.array([[1, 0, 0], [0, 0, 0], [0, 1, 1]], np.float32)  # at pixel (0, 0) the cross has pz = 0
    pix[0] = 0.0
    got = surfel_fragment_power(torch.from_numpy(t), torch.from_numpy(pix), torch.from_numpy(mean)).numpy()
    want = np.asarray(jax_power(t, pix, mean))
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want)  # the same operations in the same order: bit for bit
