"""The port's padding, file IO, metrics and flow visualization against the
JAX package's, on the CPU.

  * `InputPadder` pad/unpad (NCHW) against JAX's (NHWC): both modes, with
    and without a bucket, at odd sizes: equal;
  * `.flo`, `.pfm` and PPM round trips against the JAX readers: equal;
    the numpy PPM reader against Pillow on the same file: equal;
  * `flow_to_image`, `compute_psnr_np` and `MetricAccumulator`: equal to JAX's;
  * the X4K 2k split's area downscale against `cv2.resize(INTER_AREA)`:
    <= 1e-6 max-abs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.data import frame_io as jax_io
from gimmvfi_tpu.ops.pad import InputPadder as JaxInputPadder
from gimmvfi_tpu.ops.pad import pad_reflect as jax_pad_reflect
from gimmvfi_tpu.utils import flow_viz as jax_flow_viz
from gimmvfi_tpu.utils import metrics as jax_metrics
from gimmvfi_tpu_torch.cli.benchmarks import X4K_2K_SIZE, area_downscale
from gimmvfi_tpu_torch.data import frame_io
from gimmvfi_tpu_torch.ops.pad import InputPadder, pad_reflect
from gimmvfi_tpu_torch.utils import flow_viz, metrics

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw,divisor,bucket", [
    ((37, 53), 8, None), ((120, 176), 32, None), ((45, 70), 32, 128), ((64, 96), 32, None),
    ((33, 31), 32, 64),
])
def test_input_padder_matches_jax(mode, hw, divisor, bucket):
    img = np.random.default_rng(0).random((2, *hw, 3), dtype=np.float32)
    ref_padder = JaxInputPadder(img.shape, divisor, mode, bucket)
    padder = InputPadder(img.shape[:-1], divisor, mode, bucket)
    assert padder.padded_hw == ref_padder.padded_hw
    ref = np.asarray(ref_padder.pad(jnp.asarray(img)))
    got = padder.pad(torch.from_numpy(img).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    # a (N, T, C, H, W) stack pads the same way, and two inputs give a list
    stacked, single = padder.pad(torch.from_numpy(img).permute(0, 3, 1, 2)[None], got[:1])
    assert stacked.shape == (1, 2, 3, *padder.padded_hw)
    np.testing.assert_array_equal(stacked[0].numpy(), got.numpy())
    back = padder.unpad(got)
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref_padder.unpad(jnp.asarray(ref))))
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), img)


def test_pad_reflect_matches_jax():
    img = np.random.default_rng(1).random((1, 9, 11, 4), dtype=np.float32)
    ref = np.asarray(jax_pad_reflect(jnp.asarray(img), 2))
    got = pad_reflect(torch.from_numpy(img).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_flo_round_trip_matches_jax(tmp_path):
    flow = np.random.default_rng(2).standard_normal((13, 17, 2)).astype(np.float32)
    path = str(tmp_path / "a.flo")
    frame_io.write_flo(path, flow)
    np.testing.assert_array_equal(jax_io.read_flo(path), flow)
    np.testing.assert_array_equal(frame_io.read_flo(path), flow)
    np.testing.assert_array_equal(frame_io.read_gen(path), jax_io.read_gen(path))
    jax_path = str(tmp_path / "b.flo")
    jax_io.write_flo(jax_path, flow)
    assert open(jax_path, "rb").read() == open(path, "rb").read()
    bad = tmp_path / "bad.flo"
    bad.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        frame_io.read_flo(str(bad))


@pytest.mark.parametrize("color,scale", [(True, -1.0), (False, 1.0)])
def test_pfm_matches_jax(tmp_path, color, scale):
    shape = (5, 7, 3) if color else (5, 7)
    data = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    path = str(tmp_path / "a.pfm")
    endian = "<" if scale < 0 else ">"
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"7 5\n")
        f.write(f"{scale}\n".encode())
        f.write(np.flipud(data).astype(endian + "f4").tobytes())
    np.testing.assert_array_equal(frame_io.read_pfm(path), jax_io.read_pfm(path))
    np.testing.assert_array_equal(frame_io.read_pfm(path), data)
    np.testing.assert_array_equal(frame_io.read_gen(path), jax_io.read_gen(path))


def test_ppm_round_trip_matches_jax_and_pillow(tmp_path):
    from PIL import Image

    rgb = (np.random.default_rng(4).random((19, 23, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "a.ppm")
    frame_io.write_ppm(path, rgb)
    np.testing.assert_array_equal(frame_io.read_ppm(path), rgb)
    np.testing.assert_array_equal(frame_io.read_ppm(path), np.asarray(Image.open(path)))
    # the JAX reader goes through Pillow; the port's reads the bytes itself
    np.testing.assert_array_equal(frame_io.read_image(path), jax_io.read_image(path))
    np.testing.assert_array_equal(frame_io.read_gen(path), jax_io.read_gen(path))
    # a PPM written by Pillow, and one with a comment and odd whitespace
    pil_path = str(tmp_path / "b.ppm")
    Image.fromarray(rgb).save(pil_path)
    np.testing.assert_array_equal(frame_io.read_ppm(pil_path), rgb)
    odd = tmp_path / "c.ppm"
    odd.write_bytes(b"P6 # made by hand\n23\t19\n# maxval next\n255\n" + rgb.tobytes())
    np.testing.assert_array_equal(frame_io.read_ppm(str(odd)), rgb)
    np.testing.assert_array_equal(frame_io.read_ppm(str(odd)), np.asarray(Image.open(str(odd))))


def test_png_goes_through_pillow_as_in_jax(tmp_path):
    from PIL import Image

    rgb = (np.random.default_rng(5).random((8, 9, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(rgb).save(path)
    np.testing.assert_array_equal(frame_io.read_image(path), jax_io.read_image(path))


def test_ppm_rejects_what_it_does_not_read(tmp_path):
    p3 = tmp_path / "ascii.ppm"
    p3.write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    wide = tmp_path / "wide.ppm"
    wide.write_bytes(b"P6\n1 1\n65535\n" + b"\0" * 6)
    short = tmp_path / "short.ppm"
    short.write_bytes(b"P6\n2 2\n255\n" + b"\0" * 5)
    for path in (p3, wide, short):
        with pytest.raises(ValueError):
            frame_io.read_ppm(str(path))
    with pytest.raises(ValueError):
        frame_io.write_ppm(str(tmp_path / "x.ppm"), np.zeros((2, 2, 3), np.float32))


def test_kitti_png_flow_matches_jax(tmp_path):
    flow = (np.random.default_rng(6).standard_normal((6, 8, 2)) * 10).astype(np.float32)
    path = str(tmp_path / "k.png")
    frame_io.write_kitti_png_flow(path, flow)
    got, ref = frame_io.read_kitti_png_flow(path), jax_io.read_kitti_png_flow(path)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("scale", [1.0, 37.5, 1e-9])
def test_flow_to_image_bit_equal(scale):
    flow = (np.random.default_rng(7).standard_normal((21, 34, 2)) * scale).astype(np.float32)
    for bgr in (False, True):
        np.testing.assert_array_equal(flow_viz.flow_to_image(flow, bgr),
                                      jax_flow_viz.flow_to_image(flow, bgr))


def test_metrics_bit_equal():
    rng = np.random.default_rng(8)
    a, b = rng.random((2, 16, 16, 3), dtype=np.float32)
    assert metrics.compute_psnr_np(a, b) == jax_metrics.compute_psnr_np(a, b)
    assert metrics.compute_psnr_np(a, a) == jax_metrics.compute_psnr_np(a, a)
    ours, ref = metrics.MetricAccumulator(["psnr", "lpips"]), jax_metrics.MetricAccumulator(
        ["psnr", "lpips"])
    for acc in (ours, ref):
        acc.update({"psnr": 30.5, "lpips": 0.1}, count=3)
        acc.update({"psnr": 28.25}, count=2)
    assert ours.summary() == ref.summary() and ours.print_line() == ref.print_line()


def test_area_downscale_is_cv2_inter_area():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(9).random((2 * 27, 2 * 40, 3), dtype=np.float32)
    ref = cv2.resize(img, (40, 27), interpolation=cv2.INTER_AREA)
    got = area_downscale(img, (27, 40))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6
    assert X4K_2K_SIZE == (1080, 2048)
    with pytest.raises(ValueError):
        area_downscale(img, (20, 40))


def test_frame_io_needs_no_image_library_for_ppm(tmp_path, monkeypatch):
    """PPM frames read and write with PIL and cv2 unimportable."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    rgb = np.full((3, 4, 3), 200, np.uint8)
    path = os.path.join(tmp_path, "x.ppm")
    frame_io.write_ppm(path, rgb)
    np.testing.assert_array_equal(frame_io.read_image(path), rgb.astype(np.float32) / 255.0)
    with pytest.raises(ImportError):
        frame_io.read_image(os.path.join(tmp_path, "x.png"))
