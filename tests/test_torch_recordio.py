"""The port's ``mx.recordio`` held against the JAX package's on the CPU.

The same seeded records go through both packages: files and ``.idx``
sidecars written by either are byte-equal and read back by the other;
``IRHeader`` packing is byte-equal; the native scanner (``g++``, built
into ``build/native/<hash>/``) reads and writes what the plain Python
reader and writer do, empty records included (the JAX package's native
reader stops at an empty record, taking its length 0 for the end of the
file, so the cross-package files hold none); a build failure raises.
"""

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import _native, recordio as prec
from mxnet_tpu_torch.base import MXNetError


def _records(seed=0, n=9, empty=False):
    """Seeded payloads of 1..4099 bytes (every padding remainder), plus
    empty ones if asked."""
    rs = np.random.RandomState(seed)
    out = [rs.randint(0, 256, int(k), dtype=np.uint8).tobytes()
           for k in rs.randint(1, 4100, n)]
    out[:4] = [b"a", b"ab", b"abc", b"abcd"]
    if empty:
        out[2:2] = [b""]
        out.append(b"")
    return out


def _write(mod_cls, path, recs, idx_path=None):
    if idx_path is None:
        w = mod_cls(str(path), "w")
        for r in recs:
            w.write(r)
    else:
        w = mod_cls(str(idx_path), str(path), "w")
        for i, r in enumerate(recs):
            w.write_idx(i * 3 + 1, r)
    w.close()


def _read_all(mod_cls, path):
    r = mod_cls(str(path), "r")
    out = []
    while True:
        x = r.read()
        if x is None:
            break
        out.append(x)
    r.close()
    return out


@pytest.mark.parametrize("writer", ["native", "plain"])
def test_port_file_is_the_references_bytes_and_reads_there(tmp_path, writer):
    recs = _records()
    cls = prec.MXRecordIO if writer == "native" else prec._PlainRecordIO
    _write(cls, tmp_path / "p.rec", recs)
    _write(jrec.MXRecordIO, tmp_path / "j.rec", recs)
    assert (tmp_path / "p.rec").read_bytes() == \
        (tmp_path / "j.rec").read_bytes()
    assert _read_all(jrec.MXRecordIO, tmp_path / "p.rec") == recs


@pytest.mark.parametrize("reader", ["native", "plain"])
def test_reference_file_reads_in_the_port(tmp_path, reader):
    recs = _records(1)
    _write(jrec.MXRecordIO, tmp_path / "j.rec", recs)
    cls = prec.MXRecordIO if reader == "native" else prec._PlainRecordIO
    assert _read_all(cls, tmp_path / "j.rec") == recs


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_indexed_files_and_idx_are_byte_equal_both_ways(tmp_path, writer):
    recs = _records(2)
    _write(prec.MXIndexedRecordIO, tmp_path / "p.rec", recs,
           tmp_path / "p.idx")
    _write(jrec.MXIndexedRecordIO, tmp_path / "j.rec", recs,
           tmp_path / "j.idx")
    for ext in ("rec", "idx"):
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    src = "p" if writer == "port" else "j"
    cls = jrec.MXIndexedRecordIO if writer == "port" \
        else prec.MXIndexedRecordIO
    r = cls(str(tmp_path / f"{src}.idx"), str(tmp_path / f"{src}.rec"), "r")
    assert r.keys == [i * 3 + 1 for i in range(len(recs))]
    for k in reversed(r.keys):                 # random access
        assert r.read_idx(k) == recs[(k - 1) // 3]
    r.close()


@pytest.mark.parametrize("empty", [False, True])
def test_native_scanner_equals_the_plain_reader_and_writer(tmp_path, empty):
    """Native and plain write the same bytes and read the same records,
    empty records included (length 0 is not the end of the file)."""
    recs = _records(3, 12, empty=empty)
    _write(prec.MXRecordIO, tmp_path / "n.rec", recs)
    _write(prec._PlainRecordIO, tmp_path / "p.rec", recs)
    assert (tmp_path / "n.rec").read_bytes() == \
        (tmp_path / "p.rec").read_bytes()
    for cls in (prec.MXRecordIO, prec._PlainRecordIO):
        assert _read_all(cls, tmp_path / "n.rec") == recs
    # tell/seek: each record's start offset, as write returned it
    w = prec.MXRecordIO(str(tmp_path / "s.rec"), "w")
    pos = [w.write(r) for r in recs]
    w.close()
    for cls in (prec.MXRecordIO, prec._PlainRecordIO):
        r = cls(str(tmp_path / "s.rec"), "r")
        for k in (3, 0, len(recs) - 1):
            r.seek(pos[k])
            assert r.read() == recs[k]
        r.close()


@pytest.mark.parametrize("cls", ["native", "plain"])
def test_a_corrupt_file_raises(tmp_path, cls):
    recs = _records(4)
    _write(prec.MXRecordIO, tmp_path / "c.rec", recs)
    raw = bytearray((tmp_path / "c.rec").read_bytes())
    raw[len(recs[0]) + 8 + 3] ^= 0xFF          # the second record's magic
    (tmp_path / "c.rec").write_bytes(bytes(raw))
    klass = prec.MXRecordIO if cls == "native" else prec._PlainRecordIO
    r = klass(str(tmp_path / "c.rec"), "r")
    assert r.read() == recs[0]
    with pytest.raises(MXNetError, match="corrupt"):
        r.read()


_HEADERS = {
    "scalar_label": (prec.IRHeader(0, 3.5, 7, 0), jrec.IRHeader(0, 3.5, 7,
                                                                 0)),
    "array_label": (prec.IRHeader(0, [1.0, 2.5, -3.0], 123456789012, 4),
                    jrec.IRHeader(0, [1.0, 2.5, -3.0], 123456789012, 4)),
    "numpy_label": (prec.IRHeader(0, np.arange(5, dtype=np.float32), 1, 2),
                    jrec.IRHeader(0, np.arange(5, dtype=np.float32), 1, 2)),
}


@pytest.mark.parametrize("name", sorted(_HEADERS))
def test_irheader_pack_unpack_are_the_references(name):
    ph, jh = _HEADERS[name]
    payload = b"\x00\x01payload\xff"
    packed = prec.pack(ph, payload)
    assert packed == jrec.pack(jh, payload)
    for mod in (prec, jrec):
        h, s = mod.unpack(packed)
        assert s == payload
        jh2, _ = jrec.unpack(packed)
        assert h.flag == jh2.flag and h.id == jh2.id and h.id2 == jh2.id2
        np.testing.assert_array_equal(np.asarray(h.label),
                                      np.asarray(jh2.label))


def test_pack_img_unpack_img_are_the_references():
    """PNG (lossless) through both packages: the same bytes, the same
    pixels back (PIL; the card's machine has none)."""
    img = np.random.RandomState(5).randint(0, 256, (6, 7, 3), np.uint8)
    h = prec.IRHeader(0, 1.0, 3, 0)
    packed = prec.pack_img(h, img, img_fmt=".png")
    assert packed == jrec.pack_img(jrec.IRHeader(0, 1.0, 3, 0), img,
                                   img_fmt=".png")
    _, back = prec.unpack_img(packed, ctx=mx.cpu())
    np.testing.assert_array_equal(back.asnumpy(), img)
    np.testing.assert_array_equal(jrec.unpack_img(packed)[1], img)


def test_the_scanner_builds_into_build_native(tmp_path):
    lib = _native.recordio_lib()
    so = _native.build_dir("recordio") / "librecordio.so"
    assert so.exists() and lib is _native.load("recordio")
    assert so.parent.parent == _native.REPO_ROOT / "build" / "native"


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a g++ failure is an MXNetError naming it."""
    monkeypatch.setattr(_native, "REPO_ROOT", tmp_path)
    monkeypatch.setattr(_native, "CXX_FLAGS",
                        _native.CXX_FLAGS + ("-DNO_SUCH=", "-include",
                                             "no_such_header.h"))
    monkeypatch.setattr(_native, "_libs", {})
    with pytest.raises(MXNetError, match="g\\+\\+ failed"):
        prec.MXRecordIO(str(tmp_path / "x.rec"), "w")


def test_mx_recordio_is_the_module():
    assert mx.recordio is prec
    assert set(prec.__all__) == set(jrec.__all__)
