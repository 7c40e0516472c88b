"""The port's ``.params`` files held against the JAX package's on the
CPU: a dict of f32, f16, bf16, int32 and int8 arrays (and a 0-d and an
empty one) saved by each package gives the same bytes, each package
loads the other's file to identical values and dtypes, a list file works
both ways, and so do the V1 layout and the ``.npz`` escape hatch.
"""
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError


def _arrays(m):
    rs = np.random.RandomState(0)
    f32 = rs.randn(3, 4).astype(np.float32)
    return {
        "arg:w": m.nd.array(f32),
        "arg:h": m.nd.array(rs.randn(5).astype(np.float32), dtype="float16"),
        "arg:bf": m.nd.array(rs.randn(2, 3, 2).astype(np.float32),
                             dtype="bfloat16"),
        "aux:i": m.nd.array(rs.randint(-9, 9, (7,)), dtype="int32"),
        "aux:b": m.nd.array(rs.randint(-100, 100, (2, 2)), dtype="int8"),
        "aux:scalar": m.nd.array(np.float32(1.5)),
        "aux:empty": m.nd.zeros((0, 3)),
    }


def _value(v):
    a = v.asnumpy()
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


def _check_same(got, want):
    assert list(got) == list(want) if isinstance(want, dict) \
        else len(got) == len(want)
    for g, w in (zip(got.values(), want.values()) if isinstance(want, dict)
                 else zip(got, want)):
        assert str(g.dtype) == str(w.dtype)
        assert g.shape == w.shape
        np.testing.assert_array_equal(_value(g), _value(w))


@pytest.fixture()
def both_files(tmp_path):
    jf, pf = tmp_path / "jax.params", tmp_path / "port.params"
    jmx.nd.save(str(jf), _arrays(jmx))
    with mx.cpu():
        mx.nd.save(str(pf), _arrays(mx))
    return jf, pf


def test_dict_files_are_byte_identical(both_files):
    jf, pf = both_files
    assert pf.read_bytes() == jf.read_bytes()
    # bf16 goes with the V3 magic and dtype id 12
    assert struct.pack("<I", 0xF993FACA) in pf.read_bytes()


def test_each_package_loads_the_others_file(both_files):
    jf, pf = both_files
    want = _arrays(jmx)
    _check_same(mx.nd.load(str(jf), ctx=mx.cpu()), want)
    _check_same(jmx.nd.load(str(pf)), want)
    assert mx.nd.load(str(pf), ctx=mx.cpu())["arg:bf"]._data.dtype == \
        torch.bfloat16


def test_list_file(tmp_path):
    jf, pf = tmp_path / "jax.params", tmp_path / "port.params"
    jmx.nd.save(str(jf), list(_arrays(jmx).values()))
    with mx.cpu():
        mx.nd.save(str(pf), list(_arrays(mx).values()))
        mx.nd.array([1.0, 2.0]).save(str(tmp_path / "one.params"))
    assert pf.read_bytes() == jf.read_bytes()
    got = mx.nd.load(str(jf), ctx=mx.cpu())
    assert isinstance(got, list)
    _check_same(got, list(_arrays(jmx).values()))
    one = jmx.nd.load(str(tmp_path / "one.params"))
    np.testing.assert_array_equal(one[0].asnumpy(), [1.0, 2.0])


def test_v1_layout_and_npz(tmp_path):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    buf = struct.pack("<QQQ", 0x112, 0, 1)
    buf += struct.pack("<II", 0xF993FAC8, 2) + struct.pack("<II", 2, 3)
    buf += struct.pack("<iii", 1, 0, 0) + a.tobytes()
    buf += struct.pack("<Q", 1) + struct.pack("<Q", 1) + b"a"
    (tmp_path / "v1.params").write_bytes(buf)
    got = mx.nd.load(str(tmp_path / "v1.params"), ctx=mx.cpu())
    want = jmx.nd.load(str(tmp_path / "v1.params"))
    _check_same(got, want)
    np.savez(str(tmp_path / "x.npz"), a=a, b=a.astype(np.float64))
    got = mx.nd.load(str(tmp_path / "x.npz"), ctx=mx.cpu())
    _check_same(got, jmx.nd.load(str(tmp_path / "x.npz")))


def test_corrupt_and_missing_files_raise(tmp_path):
    with mx.cpu():
        mx.nd.save(str(tmp_path / "x.params"), {"w": mx.nd.ones((64,))})
    data = (tmp_path / "x.params").read_bytes()
    (tmp_path / "cut.params").write_bytes(data[:100])
    (tmp_path / "bad.params").write_bytes(b"\x00" * 40)
    for name in ("cut", "bad"):
        with pytest.raises(MXNetError, match=f"{name}.params"):
            mx.nd.load(str(tmp_path / f"{name}.params"), ctx=mx.cpu())
    with pytest.raises(MXNetError, match="cannot read"):
        mx.nd.load(str(tmp_path / "none.params"), ctx=mx.cpu())
    with pytest.raises(TypeError):
        mx.nd.save(str(tmp_path / "y.params"), 3)


def test_loads_takes_bytes_onto_the_default_context(tmp_path):
    f = tmp_path / "z.params"
    with mx.cpu():
        mx.nd.save(str(f), [mx.nd.array(np.arange(3, dtype=np.int64))])
        back = mx.nd.loads(f.read_bytes())
    assert back[0].context == mx.cpu()
    np.testing.assert_array_equal(back[0].asnumpy(), [0, 1, 2])
