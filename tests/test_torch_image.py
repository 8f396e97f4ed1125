"""PyTorch port, ``utils/image.py`` and the examples on the CPU:
``to_srgb_u8`` bit-equal to the JAX package's, the standard-library PNG
writer read back by PIL (and PIL's files by the port's reader, every row
filter), ``load_png`` against the JAX package's (PIL-based) reader, and the
examples (``bevy_gaussian_splatting_tpu_torch/examples/``) run with
``--device cpu`` into a temporary directory."""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_cases  # noqa: F401  (one PyTorch thread per test worker)
from bevy_gaussian_splatting_tpu.utils import image as jimage
from bevy_gaussian_splatting_tpu_torch.examples import minimal, multi_camera, train_multiview, training
from bevy_gaussian_splatting_tpu_torch.utils import image as timage


def _linear_image(h=37, w=29, seed=0) -> np.ndarray:
    """Linear RGBA with values below 0, above 1, at the OETF's knee and tiny."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.2, 1.2, (h, w, 4)).astype(np.float32)
    img[0, :, :3] = np.float32(0.0031308)
    img[1, :, :3] = np.nextafter(np.float32(0.0031308), np.float32(1.0))
    img[2, :, :3] = np.float32(1e-30)
    return img


def test_to_srgb_u8_bit_equal_to_jax():
    img = _linear_image()
    want = jimage.to_srgb_u8(img)
    np.testing.assert_array_equal(timage.to_srgb_u8(img), want)
    np.testing.assert_array_equal(timage.to_srgb_u8(torch.from_numpy(img)), want)
    assert timage.non_black_pixel_count(torch.from_numpy(img)) == jimage.non_black_pixel_count(img)


def test_png_written_is_read_by_pil_and_back(tmp_path):
    img = _linear_image()
    path = tmp_path / "port.png"
    timage.save_png(torch.from_numpy(img), path)
    pil = np.asarray(Image.open(path))
    assert Image.open(path).mode == "RGBA"
    np.testing.assert_array_equal(pil, jimage.to_srgb_u8(img))
    # the port's reader against the JAX package's (PIL) on the same file
    np.testing.assert_array_equal(timage.load_png(path), jimage.load_png(str(path)))
    jpath = tmp_path / "jax.png"
    jimage.save_png(img, str(jpath))
    np.testing.assert_array_equal(timage.load_png(jpath), jimage.load_png(str(jpath)))


def _filtered_png(rgba: np.ndarray, kinds) -> bytes:
    """An RGBA PNG whose row y is stored with filter ``kinds[y % len]``
    (PNG 1.2 section 6), encoded here independently of the port."""
    h, w, _ = rgba.shape
    x = rgba.reshape(h, w * 4).astype(np.int32)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        prev = x[y - 1] if y else np.zeros(w * 4, np.int32)
        left = np.concatenate([np.zeros(4, np.int32), x[y, :-4]])
        up_left = np.concatenate([np.zeros(4, np.int32), prev[:-4]])
        if kind == 0:
            pred = np.zeros_like(prev)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(kind)
        out += ((x[y] - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


def test_png_reader_takes_every_row_filter(tmp_path):
    rgba = np.random.default_rng(3).integers(0, 256, (11, 7, 4), dtype=np.uint8)
    blob = _filtered_png(rgba, (0, 1, 2, 3, 4))
    path = tmp_path / "filtered.png"
    path.write_bytes(blob)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgba)  # the file is valid
    np.testing.assert_array_equal(timage.decode_png(blob), rgba)
    # and PIL's own choice of filters
    Image.fromarray(rgba, mode="RGBA").save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(timage.decode_png((tmp_path / "pil.png").read_bytes()), rgba)
    Image.fromarray(rgba[..., :3]).save(tmp_path / "rgb.png")
    with pytest.raises(ValueError, match="RGBA"):
        timage.decode_png((tmp_path / "rgb.png").read_bytes())


@pytest.mark.parametrize("example,lit_share", [(minimal, 0.5), (multi_camera, 0.5)])
def test_examples_run_on_the_cpu(example, lit_share, tmp_path, capsys):
    out = tmp_path / "out.png"
    assert example.main(["--device", "cpu", "--out", str(out)]) == 0
    img = timage.load_png(out)
    assert np.isfinite(img).all()
    assert timage.non_black_pixel_count(img) > lit_share * img.shape[0] * img.shape[1]
    assert "wrote" in capsys.readouterr().out


def test_training_example_runs_on_the_cpu(tmp_path, capsys):
    """examples/training.py's protocol whole: 60 Adam steps at 64x64."""
    out = tmp_path / "training.png"
    assert training.main(["--device", "cpu", "--out", str(out)]) == 0
    img = timage.load_png(out)
    assert img.shape == (64, 128, 4) and timage.non_black_pixel_count(img) > 0.05 * 64 * 128
    first, last = (float(v) for v in capsys.readouterr().out.split("loss ")[-1].split()[0:3:2])
    assert last < 0.2 * first


def test_train_multiview_example_runs_on_the_cpu(tmp_path, capsys):
    """A few steps of the multi-view example (its 300 are the card's, in
    chip_smoke.py): it runs and writes the target beside the result."""
    out = tmp_path / "mv.png"
    assert train_multiview.main(["--device", "cpu", "--out", str(out), "--steps", "4", "--views", "2",
                                 "--n", "64", "--size", "32"]) == 0
    img = timage.load_png(out)
    assert img.shape == (32, 64, 4) and timage.non_black_pixel_count(img[:, :32]) > 0
    assert "final view0 PSNR" in capsys.readouterr().out
