"""Make the JPEG fixtures of the port's image tests, from a seed, with
Pillow: each ``<name>.jpg`` beside ``<name>.npy``, Pillow's decode of it
(``convert("RGB")``, or ``"L"`` for the gray one, as ``mx.image.imdecode``
takes it), and ``manifest.json`` saying how each was saved.

    python tests/torch_image_fixtures/make_fixtures.py

The card's machine holds the files only: ``tests/test_torch_cuda_image.py``
decodes them with nvJPEG and compares with the ``.npy`` pixels, and
``tests/test_torch_image.py`` checks on the CPU that the ``.npy`` files
are still Pillow's decode of the ``.jpg`` files.
"""
from __future__ import annotations

import io
import json
import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 17

# name: (height, width, save options); subsampling 0 = 4:4:4, 1 = 4:2:2,
# 2 = 4:2:0 (Pillow's default for RGB)
FIXTURES = {
    "rgb444": (48, 64, {"quality": 90, "subsampling": 0}),
    "rgb420": (64, 48, {"quality": 90, "subsampling": 2}),
    "rgb422": (40, 56, {"quality": 85, "subsampling": 1}),
    "gray": (45, 61, {"quality": 90}),
    "progressive": (48, 48, {"quality": 90, "progressive": True}),
    "restart": (64, 64, {"quality": 90, "restart_marker_blocks": 4}),
    "odd420": (37, 53, {"quality": 95, "subsampling": 2}),
}


def content(h: int, w: int, rs: np.random.RandomState) -> np.ndarray:
    """Smooth seeded gradients with a few hard-edged shapes and a little
    noise: what photographs give a JPEG coder."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        fx, fy, ph = rs.uniform(0.02, 0.15, 2).tolist() + [rs.uniform(0, 6)]
        img[..., c] = 128 + 90 * np.sin(fx * x + ph) * np.cos(fy * y)
    for _ in range(3):
        y0, x0 = rs.randint(0, h), rs.randint(0, w)
        r = rs.randint(4, max(5, min(h, w) // 3))
        mask = (y - y0) ** 2 + (x - x0) ** 2 < r * r
        img[mask] = rs.randint(0, 256, 3)
    img += rs.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    rs = np.random.RandomState(SEED)
    manifest = {}
    for name, (h, w, opts) in FIXTURES.items():
        pixels = content(h, w, rs)
        gray = name == "gray"
        pil = Image.fromarray(pixels).convert("L") if gray \
            else Image.fromarray(pixels)
        buf = io.BytesIO()
        pil.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(data)
        decoded = np.asarray(Image.open(io.BytesIO(data))
                             .convert("L" if gray else "RGB"))
        np.save(os.path.join(HERE, name + ".npy"), decoded)
        manifest[name] = {"height": h, "width": w, "gray": gray,
                          "options": opts, "bytes": len(data)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
