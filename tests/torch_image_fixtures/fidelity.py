"""The JPEG fixtures and the limits a decoder's pixels are held to.

One loader and one check, shared by ``tests/test_torch_cuda_image.py``
and ``chip_smoke.py``'s ``data_image`` phase, both of which decode the
fixtures with nvJPEG on the card and compare with Pillow's pixels kept
beside each file. Numpy only: the card's machine runs it without Pillow.

Limits: gray within 2 of each pixel and 4:4:4 within 3 (nvJPEG's IDCT
and colour conversion round otherwise than libjpeg's: max 3 measured on
the H100); a subsampled file at PSNR >= 40 dB and a mean |diff| <= 1.0
(its chroma upsampled by interpolation, as libjpeg's).
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_DIFF = {"gray": 2, "4:4:4": 3}
MIN_PSNR_DB = 40.0
MAX_MEAN_DIFF = 1.0
# Pillow's ``subsampling`` option; 4:2:0 is its default for RGB
_SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0"}


def load() -> dict:
    """``{name: (jpeg bytes, Pillow's pixels (H, W, C) uint8, kind)}`` in
    name order; ``kind`` is ``"gray"`` or the chroma subsampling."""
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, meta in sorted(manifest.items()):
        with open(os.path.join(HERE, name + ".jpg"), "rb") as f:
            data = f.read()
        pixels = np.load(os.path.join(HERE, name + ".npy")).reshape(
            meta["height"], meta["width"], -1)
        kind = "gray" if meta["gray"] else \
            _SUBSAMPLING[meta["options"].get("subsampling", 2)]
        out[name] = (data, pixels, kind)
    return out


def judge(got: np.ndarray, want: np.ndarray, kind: str):
    """``(record, ok)``: the max and mean |diff| and the PSNR of ``got``
    against Pillow's ``want``, and whether they meet ``kind``'s limits."""
    if got.shape != want.shape:
        return {"kind": kind, "shape": list(got.shape)}, False
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    mse = float(np.mean(d ** 2))
    rec = {"kind": kind, "max": int(d.max()), "mean": float(d.mean()),
           "psnr_db": float("inf") if mse == 0
           else float(10 * np.log10(255.0 ** 2 / mse))}
    if kind in MAX_DIFF:
        ok = rec["max"] <= MAX_DIFF[kind]
    else:
        ok = rec["psnr_db"] >= MIN_PSNR_DB and rec["mean"] <= MAX_MEAN_DIFF
    return rec, ok
