"""JPEG compression-artifact emulation on the device (port of
carla_garage_tpu/ops/jpeg.py).

A checkpoint trained on jpg-stored data expects block-DCT quantization
artifacts in its RGB input; the reference re-encodes the live camera as
JPEG at inference (sensor_agent.py:277-279). This reproduces the lossy
part of baseline JPEG: RGB -> YCbCr (BT.601 full range), 8x8 block DCT-II
as matrix products, quantization with the Annex-K tables scaled by the
libjpeg quality rule, dequantization, the inverse DCT and back to RGB.
Chroma subsampling is omitted, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.cgt.device import const

# ITU-T T.81 Annex K.1 — standard luminance / chrominance tables
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)
_Q_CHROMA = np.full((8, 8), 99, np.float32)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                     [47, 66, 99, 99]]


def _dct_basis() -> np.ndarray:
  """8-point orthonormal DCT-II basis D: X_dct = D @ x @ D.T."""
  k, n = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
  d = np.cos(np.pi * (2 * n + 1) * k / 16.0).astype(np.float32)
  d *= np.sqrt(2.0 / 8.0)
  d[0] *= 1.0 / np.sqrt(2.0)
  return d


_D = _dct_basis()


def quality_tables(quality: int):
  """Annex-K tables scaled by the libjpeg quality rule (jcparam.c)."""
  q = int(np.clip(quality, 1, 100))
  scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
  mk = lambda t: np.clip(np.floor((t * scale + 50.0) / 100.0), 1, 255
                         ).astype(np.float32)
  return mk(_Q_LUMA), mk(_Q_CHROMA)


def _blockwise(img: torch.Tensor, fn) -> torch.Tensor:
  """Apply fn to the 8x8 blocks of [..., H, W] (H, W multiples of 8)."""
  *lead, H, W = img.shape
  x = img.reshape(*lead, H // 8, 8, W // 8, 8).transpose(-3, -2)
  x = fn(x)                                   # [..., H/8, W/8, 8, 8]
  return x.transpose(-3, -2).reshape(*lead, H, W)


def jpeg_artifacts(rgb: torch.Tensor, quality: int = 80) -> torch.Tensor:
  """A JPEG encode/decode round trip of [..., H, W, 3] RGB.

  Float input is taken in [0, 1] (and returned so, clipped); uint8 in
  [0, 255]. H and W must be multiples of 8. `quality` is libjpeg's knob
  (cv2's default 95; lower is blockier)."""
  ql, qc = quality_tables(quality)
  dev = rgb.device
  d = const(_D, dev)
  is_u8 = rgb.dtype == torch.uint8
  x = rgb.to(torch.float32)
  if not is_u8:
    x = x * 255.0
  r, g, b = x[..., 0], x[..., 1], x[..., 2]
  y = 0.299 * r + 0.587 * g + 0.114 * b
  cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
  cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

  def quantize(ch, q):
    def f(blocks):
      coef = d @ (blocks - 128.0) @ d.T
      coef = torch.round(coef / q) * q
      return d.T @ coef @ d + 128.0
    return _blockwise(ch, f)

  y = quantize(y, const(ql, dev))
  cb = quantize(cb, const(qc, dev)) - 128.0
  cr = quantize(cr, const(qc, dev)) - 128.0
  out = torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                     y + 1.772 * cb], -1)
  out = torch.clamp(out, 0.0, 255.0)
  if is_u8:
    return out.to(torch.uint8)
  return out / 255.0
