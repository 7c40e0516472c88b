"""``mx.recordio`` — RecordIO container + MXNet record packing
(counterpart of ``mxnet_tpu/recordio.py``; reference
``python/mxnet/recordio.py`` over dmlc-core's recordio.h).

Byte-compatible with the JAX package and upstream MXNet: files and
``.idx`` sidecars written here load there and the reverse. The container
(framing, multi-part reassembly) is read and written by C++
(``_native/recordio.cpp``, built with ``g++`` into ``build/native/`` on
first use); a build failure raises :class:`MXNetError`, with no quiet
fallback. The pure-Python reader and writer stay as the plain version
the tests hold the native one against (``_PlainRecordIO``).

The native scanner is the reference's design, not a speed-up: on an
H100 machine's host (``python -m mxnet_tpu_torch.tools.recordio_bench``,
warm page cache) both readers scan a 1 GiB file of 8 KB token records
at 227-310 MB/s and make the pretraining driver's (8, 2048) batch in
0.29-0.37 ms against a step of about 185 ms, and on 64-byte records the
plain reader is the faster (620k-640k records/s against 270k-410k: a
ctypes call a record). ROADMAP.md lists keeping one reader.

Format: ``uint32 magic=0xced7230a; uint32 lrec = cflag<<29 | len;
payload; pad to 4``. IRHeader packs ``<IfQQ`` (flag, label, id, id2);
``flag > 0`` means `flag` extra float labels follow the header.
"""
from __future__ import annotations

import ctypes
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


_EOF = ctypes.c_uint64(-2).value       # recordio.cpp's kEof
_BAD = ctypes.c_uint64(-1).value


class MXRecordIO:
    """Sequential record file (reference: recordio.py::MXRecordIO)."""

    _native = True          # False: the plain Python reader and writer

    def __init__(self, uri, flag):
        self.uri = str(uri)
        self.flag = flag
        self._h = None
        self._lib = None
        self._pyf = None
        self.is_open = False
        self.open()

    def open(self):
        from ._native import recordio_lib

        if self.flag not in ("r", "w"):
            raise MXNetError(f"invalid flag {self.flag!r} (use 'r' or 'w')")
        if self._native:
            self._lib = recordio_lib()
            fn = self._lib.rio_open if self.flag == "r" else \
                self._lib.rio_create
            self._h = fn(self.uri.encode())
            if not self._h:
                raise MXNetError(f"cannot open {self.uri}")
        else:
            self._pyf = open(self.uri, "rb" if self.flag == "r" else "wb")
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        if self._h:
            self._lib.rio_close(self._h)
            self._h = None
        if self._pyf:
            self._pyf.close()
            self._pyf = None
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_h"] = None
        d["_lib"] = None
        d["_pyf"] = None
        is_open = d.pop("is_open")
        d["_reopen"] = is_open
        return d

    def __setstate__(self, d):
        reopen = d.pop("_reopen", False)
        self.__dict__.update(d)
        self.is_open = False
        if reopen:
            self.open()

    # -- write ---------------------------------------------------------
    def write(self, buf: bytes):
        if self.flag != "w":
            raise MXNetError("record file opened for reading")
        if self._h:
            pos = self._lib.rio_write(self._h, bytes(buf), len(buf))
            if pos == _BAD:
                raise MXNetError("recordio write failed")
            return pos
        return self._py_write(buf)

    def _py_write(self, buf):
        f = self._pyf
        start = f.tell()
        data = bytes(buf)
        kmax = _LEN_MASK
        off, part = 0, 0
        while True:
            n = min(len(data) - off, kmax)
            remain_after = len(data) - off - n
            if part == 0 and remain_after == 0:
                flag = 0
            elif part == 0:
                flag = 1
            elif remain_after == 0:
                flag = 3
            else:
                flag = 2
            f.write(struct.pack("<II", _MAGIC, (flag << 29) | n))
            f.write(data[off:off + n])
            pad = (4 - (n & 3)) & 3
            if pad:
                f.write(b"\x00" * pad)
            off += n
            part += 1
            if off >= len(data):
                return start

    def tell(self):
        if self._h:
            return self._lib.rio_tell(self._h)
        return self._pyf.tell()

    # -- read ----------------------------------------------------------
    def read(self):
        """Next record's payload bytes, or None at EOF."""
        if self.flag != "r":
            raise MXNetError("record file opened for writing")
        if self._h:
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = self._lib.rio_next(self._h, ctypes.byref(out))
            if n == _EOF:
                return None
            if n == _BAD:
                raise MXNetError(f"corrupt recordio file {self.uri}")
            return ctypes.string_at(out, n)
        return self._py_read()

    def _py_read(self):
        f = self._pyf
        parts = []
        while True:
            head = f.read(8)
            if len(head) < 8:
                return None if not parts else _corrupt(self.uri)
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                _corrupt(self.uri)
            flag, n = lrec >> 29, lrec & _LEN_MASK
            payload = f.read(n)
            if len(payload) < n:
                _corrupt(self.uri)
            f.seek((4 - (n & 3)) & 3, os.SEEK_CUR)
            parts.append(payload)
            if flag in (0, 3):
                return b"".join(parts)

    def seek(self, pos):
        if self.flag != "r":
            raise MXNetError("seek on write-mode record file")
        if self._h:
            self._lib.rio_seek(self._h, int(pos))
        else:
            self._pyf.seek(int(pos))


def _corrupt(uri):
    raise MXNetError(f"corrupt recordio file {uri}")


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file with a text .idx sidecar
    (reference: recordio.py::MXIndexedRecordIO; idx lines "key\\tpos")."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = str(idx_path)
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    k, pos = line.split("\t")
                    key = self.key_type(k)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.flag == "w":
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.write(buf)
        self.idx[key] = int(pos)
        self.keys.append(key)


class _PlainRecordIO(MXRecordIO):
    """The pure-Python reader and writer: the plain version of the native
    scanner."""

    _native = False


class _PlainIndexedRecordIO(MXIndexedRecordIO):
    _native = False


IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a header + payload into one record (reference: recordio.pack)."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        extra = label.tobytes()
    else:
        extra = b""
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + extra + bytes(s)


def unpack(s: bytes):
    """Inverse of pack: (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image and pack it (reference: pack_img, where
    Pillow replaces cv2). An image on the card (an NDArray or tensor on a
    CUDA device) is encoded there by nvJPEG, JPEG only (4:2:0, as
    Pillow's default for RGB; the bytes differ from Pillow's, the pixels
    they decode to agree to the codecs' rounding); any other image by
    Pillow on the host."""
    import io as _io

    import torch

    from .ndarray import NDArray

    fmt = img_fmt.lower().lstrip(".")
    fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG"}.get(fmt)
    if fmt is None:
        raise MXNetError(f"unsupported image format {img_fmt!r}")
    t = img._data if isinstance(img, NDArray) else img
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        if fmt != "JPEG":
            raise MXNetError(
                f"pack_img on the card encodes JPEG only (nvJPEG), not "
                f"{img_fmt!r}: PNG and the other codecs are ROADMAP.md queue "
                "1 item 10 (image codecs); pass a host image for Pillow")
        from .kernels import jpeg

        return pack(header, jpeg.encode(t.to(torch.uint8), quality))
    from .image import _pil

    if isinstance(t, torch.Tensor):
        t = t.detach().numpy()
    img = np.asarray(t, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    buf = _io.BytesIO()
    _pil().fromarray(img).save(
        buf, format=fmt, **({"quality": quality} if fmt == "JPEG" else {}))
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=1, ctx=None):
    """Inverse of pack_img: (IRHeader, HWC uint8 NDArray) decoded on
    ``ctx`` (default: the current context, the card), as
    ``mx.image.imdecode``: by nvJPEG on the card, by Pillow on the CPU
    (the reference returns Pillow's numpy array; gray is one channel
    here, ``(H, W, 1)``)."""
    from .image import imdecode

    header, payload = unpack(s)
    return header, imdecode(payload, flag=1 if iscolor else 0, ctx=ctx)
