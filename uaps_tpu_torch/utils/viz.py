"""Visualisations of the eval CLI without OpenCV: PNG files written with
`zlib` and `struct`, the NEU palette of JAX `uaps_tpu/eval.py` and
OpenCV's JET colormap as a 256-entry table (RGB), which the tests hold
equal to `cv2.applyColorMap(..., cv2.COLORMAP_JET)`."""
from __future__ import annotations

import struct
import zlib

import numpy as np

# NEU colour map of the notebooks' decode_segmap-style viz (JAX eval.py)
PALETTE = np.asarray(
    [[0, 0, 0], [220, 20, 60], [0, 200, 70], [30, 100, 220],
     [250, 170, 30], [170, 30, 250], [30, 250, 250]], np.uint8)

# cv2.COLORMAP_JET, entry v the RGB colour of the uint8 value v
JET = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"), np.uint8).reshape(256, 3)


def colorize(mask: np.ndarray) -> np.ndarray:
    """Class map [H, W] -> RGB [H, W, 3] in PALETTE's colours."""
    return PALETTE[np.clip(mask, 0, len(PALETTE) - 1)]


def jet(values: np.ndarray) -> np.ndarray:
    """uint8 map [H, W] -> RGB [H, W, 3] through JET."""
    return JET[values]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of `rgb` [H, W, 3] uint8 (each row filter 0)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_chunk(b"IEND", b""))
