"""The port's kernel modules (mxnet_tpu_torch/kernels, ops/attention)
held against the JAX package on the CPU.

Each kernel's plain PyTorch version is compared with the JAX Pallas
kernel run in interpret mode and with the JAX eager op, on the same
seeded numpy inputs. The CUDA kernels themselves run only on the card:
tests/test_torch_cuda_kernels.py holds them against their plain
versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.pallas_kernels import fused_layers as jfl
from mxnet_tpu.pallas_kernels.paged_attention import \
    paged_attention_kernel as jax_paged_kernel

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import (fused_rms_norm, fused_rms_norm_reference,
                                     paged_attention_reference)
from mxnet_tpu_torch.kernels.paged_attention import _check as paged_check
from mxnet_tpu_torch.ops import attention as pattn

# bf16 keeps 8 significant bits: a value that rounds differently in the
# two frameworks (statistics summed in another order) is off by at most
# one bf16 ulp, i.e. 2**-7 of its magnitude. RMSNorm with a bf16 output
# rounds twice (xhat, then the product with the weight): two ulps
BF16_RTOL = 2.0 ** -7
BF16_OUT_RTOL = 2.0 ** -6


def _np(x):
    """A torch or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """The same numpy values as a (jax, torch) pair in ``dtype``."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


# ---------------------------------------------------------------------------
# fused RMSNorm
# ---------------------------------------------------------------------------

RMS_CASES = [
    # (x dtype, weight dtype, rtol, atol): f32 differs only in the
    # order of the f32 sum of squares
    ("float32", "float32", 1e-5, 1e-5),
    ("bfloat16", "bfloat16", BF16_OUT_RTOL, 0.0),
    # mixed promotion (tests/test_pallas_fused_layers.py:164): bf16 x,
    # f32 weight -> f32 output, xhat rounded to bf16 first
    ("bfloat16", "float32", BF16_RTOL, 0.0),
]


@pytest.mark.parametrize("xdt,wdt,rtol,atol", RMS_CASES)
def test_rms_plain_matches_jax(xdt, wdt, rtol, atol):
    rs = np.random.RandomState(3)
    x = rs.randn(16, 256).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    jx, tx = _pair(x, xdt)
    jw, tw = _pair(w, wdt)
    out = fused_rms_norm_reference(tx, tw, eps=1e-5)
    j_kernel = jfl.fused_rms_norm(jx, jw, eps=1e-5, interpret=True)
    j_op = jattn.rms_norm(jx, jw, eps=1e-5)
    assert str(out.dtype).split(".")[-1] == str(j_kernel.dtype) \
        == str(j_op.dtype)
    for ref in (j_kernel, j_op):
        np.testing.assert_allclose(_np(out), _np(ref), rtol=rtol, atol=atol)


def test_rms_wrapper_routes_cpu_tensors_to_plain_version():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(3, 5, 64).astype(np.float32))
    w = torch.from_numpy(rs.randn(64).astype(np.float32))
    before = fused_rms_norm.launches
    out = pattn.rms_norm(x, w, eps=1e-6)
    assert fused_rms_norm.launches == before          # no kernel launch
    assert torch.equal(out, fused_rms_norm_reference(x, w, eps=1e-6))


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_case(dtype, seed=0):
    """GQA 4:1, head dim 128, page size 8, ragged lengths over
    scratch-padded page tables; row 2 is an empty (length-0) row."""
    rs = np.random.RandomState(seed)
    b, h, kv, d, n_pages, ps = 3, 8, 2, 128, 10, 8
    k = rs.randn(n_pages * ps, kv, d).astype(np.float32)
    v = rs.randn(n_pages * ps, kv, d).astype(np.float32)
    q = rs.randn(b, h, 1, d).astype(np.float32)
    table = np.array([[1, 2, 0, 0], [3, 4, 5, 9], [0, 0, 0, 0]], np.int32)
    lengths = np.array([13, 29, 0], np.int32)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    return ((jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths)),
            (tq, tk, tv, torch.from_numpy(table),
             torch.from_numpy(lengths)), ps, 1.0 / np.sqrt(d))


@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float32", 1e-5, 1e-5),
    # bf16 output: one rounding of an f32 result that may differ in the
    # last f32 bits between the frameworks
    ("bfloat16", BF16_RTOL, 1e-6),
])
def test_paged_plain_matches_jax_kernel_on_real_rows(dtype, rtol, atol):
    jargs, targs, ps, scale = _paged_case(dtype)
    out = paged_attention_reference(*targs, page_size=ps, scale=scale)
    ref = jax_paged_kernel(*jargs, page_size=ps, scale=scale,
                           interpret=True)
    assert tuple(out.shape) == tuple(ref.shape) == (3, 8, 1, 128)
    assert out.dtype == targs[0].dtype
    real = np.asarray(jargs[4]) > 0
    np.testing.assert_allclose(_np(out)[real], _np(ref)[real],
                               rtol=rtol, atol=atol)
    if dtype == "float32":
        # the JAX eager gather agrees on real rows too
        jq, jk, jv, jpt, jln = jargs
        gather = jattn._paged_reference(jq, jk, jv, jpt, jln,
                                        (jln - 1)[:, None], ps, scale)
        np.testing.assert_allclose(_np(out)[real], _np(gather)[real],
                                   rtol=1e-5, atol=1e-5)


def test_paged_empty_row_emits_zero():
    _, targs, ps, scale = _paged_case("float32")
    out = paged_attention_reference(*targs, page_size=ps, scale=scale)
    assert torch.count_nonzero(out[2]) == 0
    assert torch.isfinite(out).all()


def test_paged_wrapper_checks_shapes():
    _, (q, k, v, pt, ln), ps, _ = _paged_case("float32")
    paged_check(q, k, v, pt, ln, ps)                     # the valid case
    bad = [
        (q[:, :, :, :64].contiguous(), k, v, pt, ln, ps),  # D mismatch
        (q, k, v, pt.long(), ln, ps),                      # table dtype
        (q, k, v, pt, ln, 7),                              # page size
        (torch.cat([q, q], 2), k, v, pt, ln, ps),          # two queries
        (q.to(torch.bfloat16), k, v, pt, ln, ps),          # mixed dtype
        (q[:, :6].contiguous(), k, v, pt, ln, ps),         # group of 3
    ]
    for args in bad:
        with pytest.raises(MXNetError):
            paged_check(*args)


# ---------------------------------------------------------------------------
# the ops around the kernels
# ---------------------------------------------------------------------------

def test_rope_at_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 5, 4, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    out = pattn.rope_at(torch.from_numpy(x), torch.from_numpy(pos).long(),
                        theta=10000.0)
    ref = jattn.rope_at(jnp.asarray(x), jnp.asarray(pos), theta=10000.0)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        _np(pattn.rope(torch.from_numpy(x), theta=10000.0)),
        _np(pattn.rope_at(torch.from_numpy(x),
                          torch.arange(5).expand(2, 5), theta=10000.0)))


def test_paged_attention_prefill_matches_jax():
    """Lq > 1 takes the gather path in both packages."""
    rs = np.random.RandomState(6)
    b, h, kv, d, ps, lq = 2, 4, 2, 16, 4, 6
    k = rs.randn(12 * ps, kv, d).astype(np.float32)
    v = rs.randn(12 * ps, kv, d).astype(np.float32)
    q = rs.randn(b, h, lq, d).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    lengths = np.array([11, 6], np.int32)
    pos = np.stack([np.arange(5, 11), np.arange(0, 6)]).astype(np.int32)
    out = pattn.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(lengths),
        q_positions=torch.from_numpy(pos).long(), page_size=ps)
    ref = jattn.paged_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(table),
                                jnp.asarray(lengths),
                                q_positions=jnp.asarray(pos), page_size=ps)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
