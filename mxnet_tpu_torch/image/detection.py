"""Detection image pipeline (counterpart of ``mxnet_tpu/image/detection.py``;
reference ``python/mxnet/image/detection.py``: the ``DetAugmenter`` zoo,
``CreateDetAugmenter``, ``ImageDetIter``).

Labels ride the record header as a flat array ``[header_width,
object_width, <extras...>, obj0..., obj1...]``, each object ``[cls, xmin,
ymin, xmax, ymax, ...]`` in normalized [0, 1] coordinates. Augmenters
transform the image (a tensor on its device, as in ``mx.image``) and the
boxes (float32 numpy on the host) together, with the reference's draws;
the iterator pads each batch's label block to a fixed object count with
-1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray
from . import (Augmenter, BrightnessJitterAug, CastAug, ColorNormalizeAug,
               ContrastJitterAug, ForceResizeAug, ImageIter, RandomGrayAug,
               SaturationJitterAug, _decode, _finish, _py, _t)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetRandomPadAug", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Image+label augmenter base (reference: detection.py::DetAugmenter)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline
    (reference: DetBorrowAug): geometry-preserving augmenters only."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise MXNetError("DetBorrowAug wraps an image Augmenter")
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _py().random() < self.p:
            src = NDArray(torch.flip(_t(src), (1,)))
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """SSD-style random crop with object-coverage constraints
    (reference: DetRandomCropAug)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _coverage(self, boxes, crop):
        cx1, cy1, cx2, cy2 = crop
        ix1 = np.maximum(boxes[:, 0], cx1)
        iy1 = np.maximum(boxes[:, 1], cy1)
        ix2 = np.minimum(boxes[:, 2], cx2)
        iy2 = np.minimum(boxes[:, 3], cy2)
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        area = np.clip(boxes[:, 2] - boxes[:, 0], 1e-12, None) * \
            np.clip(boxes[:, 3] - boxes[:, 1], 1e-12, None)
        return inter / area

    def __call__(self, src, label):
        arr = _t(src)
        h, w = arr.shape[:2]
        valid = label[:, 0] >= 0
        boxes = label[valid, 1:5]
        for _ in range(self.max_attempts):
            scale = _py().uniform(*self.area_range)
            ratio = _py().uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(scale * ratio))
            ch = min(1.0, np.sqrt(scale / ratio))
            cx = _py().uniform(0, 1.0 - cw)
            cy = _py().uniform(0, 1.0 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            if boxes.size:
                cov = self._coverage(boxes, crop)
                keep = cov >= self.min_object_covered
                if not keep.any():
                    continue
            x1p, y1p = int(cx * w), int(cy * h)
            x2p, y2p = int((cx + cw) * w), int((cy + ch) * h)
            out = NDArray(arr[y1p:y2p, x1p:x2p, :].contiguous())
            new_label = np.full_like(label, -1.0)
            if boxes.size:
                kept = boxes[keep].copy()
                kept[:, [0, 2]] = np.clip(
                    (kept[:, [0, 2]] - cx) / cw, 0.0, 1.0)
                kept[:, [1, 3]] = np.clip(
                    (kept[:, [1, 3]] - cy) / ch, 0.0, 1.0)
                rows = label[valid][keep]
                rows[:, 1:5] = kept
                new_label[:len(rows)] = rows
            return out, new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Expand the canvas and place the image randomly (zoom-out,
    reference: DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        arr = _t(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            scale = _py().uniform(*self.area_range)
            if scale < 1.0:
                continue
            ratio = _py().uniform(*self.aspect_ratio_range)
            nw, nh = int(w * np.sqrt(scale * ratio)), \
                int(h * np.sqrt(scale / ratio))
            if nw < w or nh < h:
                continue
            ox = _py().randint(0, nw - w)
            oy = _py().randint(0, nh - h)
            fill = np.asarray(self.pad_val).astype(
                np.dtype(str(arr.dtype).replace("torch.", "")))
            canvas = torch.empty((nh, nw, arr.shape[2]), dtype=arr.dtype,
                                 device=arr.device)
            canvas[...] = torch.from_numpy(fill[:arr.shape[2]]).to(
                arr.device)
            canvas[oy:oy + h, ox:ox + w, :] = arr
            label = label.copy()
            valid = label[:, 0] >= 0
            label[valid, 1] = (label[valid, 1] * w + ox) / nw
            label[valid, 3] = (label[valid, 3] * w + ox) / nw
            label[valid, 2] = (label[valid, 2] * h + oy) / nh
            label[valid, 4] = (label[valid, 4] * h + oy) / nh
            return NDArray(canvas), label
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, hue=0,
                       pad_val=(127, 127, 127), min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50):
    """Standard detection pipeline (reference:
    detection.py::CreateDetAugmenter)."""
    auglist = []
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])), max_attempts))
    if rand_pad > 0:
        auglist.append(DetRandomPadAug(
            aspect_ratio_range, (1.0, max(1.0, area_range[1])),
            max_attempts, pad_val))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # geometry settles: force to the model's input size
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]))))
    if brightness:
        auglist.append(DetBorrowAug(BrightnessJitterAug(brightness)))
    if contrast:
        auglist.append(DetBorrowAug(ContrastJitterAug(contrast)))
    if saturation:
        auglist.append(DetBorrowAug(SaturationJitterAug(saturation)))
    if hue:
        from . import HueJitterAug

        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        # only True takes the ImageNet defaults; a component left None is
        # the identity
        if mean is True:
            mean = np.array([123.68, 116.28, 103.53])
        elif mean is None:
            mean = np.zeros(3)
        if std is True:
            std = np.array([58.395, 57.12, 57.375])
        elif std is None:
            std = np.ones(3)
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection record iterator (reference: detection.py::ImageDetIter).

    Yields NCHW float32 batches plus ``(batch, max_objects,
    object_width)`` labels, -1-padded, on the iterator's context. The
    object count and width are found by scanning the whole record file
    (the reference's ``_estimate_label_shape``) unless ``label_shape`` is
    given. Samples are decoded one at a time, serially, and draw from
    the global streams, as the reference's (it takes no per-sample
    seed)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, shuffle=False, aug_list=None,
                 label_shape=None, **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        kwargs.setdefault("worker_mode", "serial")
        super().__init__(batch_size, data_shape, path_imgrec=path_imgrec,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         aug_list=[], label_width=1, **kwargs)
        self.auglist = aug_list
        if label_shape is None:
            label_shape = self._estimate_label_shape()
        self.label_shape = tuple(label_shape)
        from ..io import DataDesc

        self.provide_label = [DataDesc(
            "label", (batch_size,) + self.label_shape, "float32", "N")]
        self.reset()

    @staticmethod
    def _parse_label(raw):
        raw = np.asarray(raw, np.float32).ravel()
        if raw.size < 2:
            raise MXNetError(
                "detection label must start with [header_width, "
                "object_width, ...]")
        a, b = int(raw[0]), int(raw[1])
        if b < 5:
            raise MXNetError(f"object_width {b} < 5 (cls + 4 coords)")
        body = raw[a:]
        if body.size % b:
            raise MXNetError(
                f"label body size {body.size} not divisible by "
                f"object_width {b}")
        return body.reshape(-1, b)

    def _estimate_label_shape(self):
        max_objs, width = 1, 5
        self.reset()
        while True:
            sample = self._next_sample()
            if sample is None:
                break
            label, _payload = sample
            objs = self._parse_label(label)
            max_objs = max(max_objs, objs.shape[0])
            width = max(width, objs.shape[1])
        self.reset()
        return (max_objs, width)

    def next(self):
        from ..io import DataBatch

        c, h, w = self.data_shape
        mo, lw = self.label_shape
        data = torch.zeros((self.batch_size, c, h, w), dtype=torch.float32,
                           device=self._device)
        labels = np.full((self.batch_size, mo, lw), -1.0, np.float32)
        i = 0
        while i < self.batch_size:
            sample = self._next_sample()
            if sample is None:
                break
            raw_label, payload = sample
            objs = self._parse_label(raw_label)
            padded = np.full((mo, lw), -1.0, np.float32)
            n = min(len(objs), mo)
            padded[:n, :objs.shape[1]] = objs[:n]
            img = NDArray(_decode(bytes(payload), 1 if c == 3 else 0, 1,
                                  self._device))
            for aug in self.auglist:
                img, padded = aug(img, padded)
            data[i] = _finish(img, np.dtype(np.float32))
            labels[i] = padded
            i += 1
        if i == 0:
            raise StopIteration
        pad = self.batch_size - i
        for j in range(i, self.batch_size):
            data[j] = data[j % i]
            labels[j] = labels[j % i]
        return DataBatch(data=[NDArray(data)],
                         label=[NDArray(torch.from_numpy(labels).to(
                             self._device))],
                         pad=pad)

    def reshape(self, data_shape=None, label_shape=None):
        """Change batch shapes between epochs (reference:
        ImageDetIter.reshape)."""
        from ..io import DataDesc

        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(
                "data", (self.batch_size,) + self.data_shape, "float32",
                "NCHW")]
        if label_shape is not None:
            self.label_shape = tuple(label_shape)
            self.provide_label = [DataDesc(
                "label", (self.batch_size,) + self.label_shape, "float32",
                "N")]
