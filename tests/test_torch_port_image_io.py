"""The port's own image codec against PIL, and its debug images against
the JAX package's, on the CPU.

PIL is the reference here and only here: the port reads and writes PNG and
JPEG through ``utils/image_io`` (C++ for the JPEG and the PNG row filters,
built with g++ at first use). A PNG decodes exactly. A JPEG decodes to
PIL's pixels exactly: the port's decoder repeats libjpeg's integer
arithmetic (the JDCT_ISLOW inverse DCT, the h2v1 / h2v2 "fancy"
upsampling and the table-driven YCbCr->RGB of PIL's defaults), which
libjpeg-turbo's SIMD paths reproduce bit for bit. Where two encoders'
files are compared, their decodes are held to PSNR.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from carla_garage_tpu.utils import visualization as jvis
from carla_garage_tpu_torch.utils import image_io, visualization as vis


def camera_like(seed, h=256, w=1024):
  """A flat-shaded frame with edges and noise, as the renderer gives."""
  rng = np.random.default_rng(seed)
  y, x = np.mgrid[0:h, 0:w]
  img = np.stack([128 + 100 * np.sin(x / 37.0 + y / 53.0),
                  128 + 90 * np.cos(x / 23.0), x * 255.0 / w], -1)
  img[h // 2:, : w // 3] = (90, 90, 95)                     # a road patch
  return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def pil_bytes(img, fmt, **kw):
  b = io.BytesIO()
  Image.fromarray(img).save(b, format=fmt, **kw)
  return b.getvalue()


def pil_decode(data):
  return np.asarray(Image.open(io.BytesIO(data)))


def same_pixels(got, want, what):
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_array_equal(got, want, err_msg=str(what))


def psnr(a, ref):
  return 10 * np.log10(255.0 ** 2 / np.mean(
      (a.astype(np.float64) - ref) ** 2))


def segments(data):
  """{marker: [segment bodies]} of a JPEG's header, up to its scan."""
  out, pos = {}, 2
  while data[pos] == 0xFF:
    m = data[pos + 1]
    n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    out.setdefault(m, []).append(data[pos + 4:pos + 2 + n])
    if m == 0xDA:
      break
    pos += 2 + n
  return out


# ------------------------------------------------------------------ PNG --
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_png_written_by_pil_reads_exactly(mode):
  rng = np.random.default_rng(0)
  shape = (37, 53) if mode == "L" else (37, 53, 3)
  for img in (rng.integers(0, 256, shape, np.uint8),
              camera_like(1, 40, 64)[..., 0] if mode == "L" else
              camera_like(1, 40, 64)):
    data = pil_bytes(np.ascontiguousarray(img), "PNG")
    np.testing.assert_array_equal(image_io.decode_png(data), img)
    data = pil_bytes(np.ascontiguousarray(img), "PNG", optimize=True)
    np.testing.assert_array_equal(image_io.decode_png(data), img)


def filter_row(row, prev, bpp, kind):
  """One PNG row filtered by hand (PNG specification, section 9)."""
  out = np.zeros_like(row)
  for x in range(len(row)):
    a = int(row[x - bpp]) if x >= bpp else 0
    b = int(prev[x])
    c = int(prev[x - bpp]) if x >= bpp else 0
    p = a + b - c
    paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) \
        else (b if abs(p - b) <= abs(p - c) else c)
    pred = [0, a, b, (a + b) // 2, paeth][kind]
    out[x] = (int(row[x]) - pred) % 256
  return out


@pytest.mark.parametrize("channels", [1, 3])
def test_png_hand_made_rows_of_each_filter(channels):
  """Rows filtered by hand with types 0-4 in turn (a row of each type
  after a row of each type), in two IDAT chunks: the port and PIL both
  read back the image."""
  rng = np.random.default_rng(1)
  h, w = 12, 9
  img = rng.integers(0, 256, (h, w, channels), np.uint8)
  img[4:8] = img[3]                          # repeated rows
  flat = img.reshape(h, w * channels)
  raw = bytearray()
  for y in range(h):
    kind = (y * 3) % 5
    prev = flat[y - 1] if y else np.zeros_like(flat[0])
    raw += bytes([kind]) + filter_row(flat[y], prev, channels, kind).tobytes()
  z = zlib.compress(bytes(raw))

  def chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))
  data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
      ">IIBBBBB", w, h, 8, 0 if channels == 1 else 2, 0, 0, 0)) +
          chunk(b"tEXt", b"Comment\x00hand-made") +
          chunk(b"IDAT", z[:20]) + chunk(b"IDAT", z[20:]) +
          chunk(b"IEND", b""))
  want = img[..., 0] if channels == 1 else img
  np.testing.assert_array_equal(pil_decode(data), want)
  np.testing.assert_array_equal(image_io.decode_png(data), want)


@pytest.mark.parametrize("filter_type", range(5))
def test_port_png_read_by_pil_exactly(filter_type, tmp_path):
  rng = np.random.default_rng(2)
  for img in (rng.integers(0, 7, (31, 45), np.uint8), camera_like(3, 24, 40)):
    path = tmp_path / "x.png"
    image_io.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(image_io.read_png(path), img)


def test_png_alpha_dropped_and_other_formats_refused():
  rng = np.random.default_rng(3)
  rgba = rng.integers(0, 256, (10, 11, 4), np.uint8)
  np.testing.assert_array_equal(
      image_io.decode_png(pil_bytes(rgba, "PNG")), rgba[..., :3])
  pal = Image.fromarray(rng.integers(0, 11, (10, 11), np.uint8), "P")
  b = io.BytesIO()
  pal.save(b, format="PNG")
  for data in (b.getvalue(), pil_bytes(np.zeros((4, 4), np.uint16), "PNG")):
    with pytest.raises(ValueError, match="unsupported PNG"):
      image_io.decode_png(data)
  with pytest.raises(ValueError):
    image_io.decode_png(b"GIF89a")


# ----------------------------------------------------------------- JPEG --
@pytest.mark.parametrize("kw", [
    dict(quality=90), dict(quality=90, subsampling=0),
    dict(quality=90, subsampling=1), dict(quality=75),
    dict(quality=95, restart_marker_blocks=5)],
    ids=["q90-420", "q90-444", "q90-422", "q75-420", "q95-restart"])
def test_pil_jpeg_decodes_to_pil_pixels(kw):
  for img in (camera_like(4), camera_like(5, 37, 53)):
    data = pil_bytes(img, "JPEG", **kw)
    same_pixels(image_io.decode_jpeg(data), pil_decode(data), kw)


def test_pil_gray_jpeg_decodes_to_pil_pixels(tmp_path):
  img = camera_like(6, 64, 96)[..., 1].copy()
  data = pil_bytes(img, "JPEG", quality=90)
  got = image_io.decode_jpeg(data)
  assert got.shape == (64, 96)
  same_pixels(got, pil_decode(data), "gray")
  (tmp_path / "g.jpg").write_bytes(data)
  np.testing.assert_array_equal(image_io.read_jpeg(tmp_path / "g.jpg"), got)


def test_port_jpeg_q90_against_pil():
  """The port's quality-90 4:2:0 file read by PIL: within 1 dB of PIL's
  own file's PSNR, with PIL's quantization and Huffman tables."""
  img = camera_like(7)
  ours = image_io.encode_jpeg(img, quality=90)
  theirs = pil_bytes(img, "JPEG", quality=90)
  p_ours, p_theirs = psnr(pil_decode(ours), img), psnr(pil_decode(theirs),
                                                       img)
  assert p_ours >= p_theirs - 1.0, (p_ours, p_theirs)
  s_ours, s_theirs = segments(ours), segments(theirs)
  dqt = lambda s: b"".join(s[0xDB])
  assert dqt(s_ours) == dqt(s_theirs)
  assert b"".join(s_ours[0xC4]) == b"".join(s_theirs[0xC4])
  assert s_ours[0xC0] == s_theirs[0xC0]
  same_pixels(image_io.decode_jpeg(ours), pil_decode(ours), "port file")


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_port_jpeg_sampling_and_restarts_read_by_pil(subsampling):
  for img in (camera_like(8, 48, 80), camera_like(9, 37, 53)):
    for restart in (0, 3):
      data = image_io.encode_jpeg(img, 90, subsampling, restart)
      assert (b"\xff\xdd" in data) == bool(restart)
      ref = pil_decode(data)
      assert psnr(ref, img) > 30
      same_pixels(image_io.decode_jpeg(data), ref, (subsampling, restart))
  gray = camera_like(10, 40, 56)[..., 2].copy()
  data = image_io.encode_jpeg(gray, 90)
  same_pixels(image_io.decode_jpeg(data), pil_decode(data), "gray")


def test_jpeg_refuses_what_it_does_not_decode():
  img = camera_like(11, 32, 32)
  with pytest.raises(ValueError, match="unsupported"):
    image_io.decode_jpeg(pil_bytes(img, "JPEG", progressive=True))
  with pytest.raises(ValueError):
    image_io.decode_jpeg(pil_bytes(img, "JPEG")[:300])
  with pytest.raises(ValueError):
    image_io.decode_jpeg(b"\x89PNG")
  with pytest.raises(TypeError):
    image_io.encode_jpeg(img.astype(np.float32))


# ------------------------------------------------- debug images (JAX's) --
def test_bev_to_rgb_and_camera_panel_match_jax(tmp_path):
  rng = np.random.default_rng(12)
  bev = rng.integers(0, 11, (64, 64))
  np.testing.assert_array_equal(vis.bev_to_rgb(bev), jvis.bev_to_rgb(bev))
  rgb = rng.uniform(-0.1, 1.1, (32, 48, 3)).astype(np.float32)
  sem = rng.integers(0, 7, (32, 48))
  depth = rng.uniform(0, 80, (32, 48)).astype(np.float32)
  palette = rng.uniform(0, 1, (7, 3)).astype(np.float32)
  vis.camera_panel(str(tmp_path / "port.png"), rgb, sem, depth, palette)
  jvis.camera_panel(str(tmp_path / "jax.png"), rgb, sem, depth, palette)
  got = image_io.read_png(tmp_path / "port.png")
  assert got.shape == (96, 48, 3)
  np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path /
                                                           "jax.png")))
  vis.save_png(str(tmp_path / "f.png"), depth / 80.0)
  jvis.save_png(str(tmp_path / "g.png"), depth / 80.0)
  np.testing.assert_array_equal(image_io.read_png(tmp_path / "f.png"),
                                image_io.read_png(tmp_path / "g.png"))


def test_plot_episode_writes_jax_size(tmp_path):
  pytest.importorskip("matplotlib")
  rng = np.random.default_rng(13)
  raster = (rng.uniform(size=(2, 80, 80)) > 0.5).astype(np.uint8)
  route = np.cumsum(rng.uniform(0, 1, (30, 2)), 0)
  traj = route + rng.normal(0, 0.2, route.shape)
  args = (raster, (0.0, 0.0), 2.0, route, traj, traj[5:7], "episode 0")
  vis.plot_episode(str(tmp_path / "port.png"), *args)
  jvis.plot_episode(str(tmp_path / "jax.png"), *args)
  assert Image.open(tmp_path / "port.png").size == \
      Image.open(tmp_path / "jax.png").size
  assert image_io.read_png(tmp_path / "port.png").shape[:2] == \
      np.asarray(Image.open(tmp_path / "jax.png")).shape[:2]
