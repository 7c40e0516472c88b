"""The BERT path's kernel modules of the port (fused LayerNorm with and
without the residual, bias+GELU, flash attention forward, and
``sdp_attention`` around them) held against the JAX package on the CPU.

Each plain PyTorch version is compared with the JAX Pallas kernel run in
interpret mode (the per-kernel oracle) and, in f32, with the JAX eager
composition, on the same seeded numpy inputs. The CUDA kernels
themselves run only on the card: tests/test_torch_cuda_kernels.py holds
them against these plain versions there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.pallas_kernels import fused_layers as jfl
from mxnet_tpu.pallas_kernels.flash_attention import \
    _flash_fwd_pallas as jax_flash_fwd
from mxnet_tpu.pallas_kernels.flash_attention import \
    flash_attention as jax_flash

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import (flash_attention, flash_attention_fwd,
                                     flash_attention_reference,
                                     fused_bias_gelu,
                                     fused_bias_gelu_reference,
                                     fused_layer_norm,
                                     fused_layer_norm_reference)
from mxnet_tpu_torch.ops import attention as pattn
from mxnet_tpu_torch.ops import nn as pnn

# bf16 keeps 8 significant bits, so one ulp is at most 2**-7 of a
# value's magnitude. Where both sides compute the same f32 value and
# round it to bf16 once, an f32 difference in the last bits can still
# land on either side of a rounding boundary: one ulp.
BF16_RTOL = 2.0 ** -7


def _np(x):
    """A torch or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """The same numpy values as a (jax, torch) pair in ``dtype``."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


# ---------------------------------------------------------------------------
# fused LayerNorm (+ residual)
# ---------------------------------------------------------------------------

LN_CASES = [
    # (x dtype, gamma dtype, rtol, atol). f32: the statistics are summed
    # in another order. bf16 output: one rounding of the f32 result.
    ("float32", "float32", 1e-5, 1e-5),
    ("bfloat16", "bfloat16", BF16_RTOL, 1e-6),
    ("bfloat16", "float32", BF16_RTOL, 1e-6),
]


@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("xdt,gdt,rtol,atol", LN_CASES)
def test_layer_norm_plain_matches_jax_kernel(with_res, xdt, gdt, rtol,
                                             atol):
    rs = np.random.RandomState(1)
    x = (3.0 + rs.randn(16, 256)).astype(np.float32)
    r = rs.randn(16, 256).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    b = (0.1 * rs.randn(256)).astype(np.float32)
    jx, tx = _pair(x, xdt)
    jr, tr = _pair(r, xdt)
    jg, tg = _pair(g, gdt)
    jb, tb = _pair(b, gdt)
    out, mean, rstd = fused_layer_norm_reference(
        tx, tg, tb, tr if with_res else None, eps=1e-5, return_stats=True)
    assert out.dtype == tx.dtype and mean.shape == rstd.shape == (16,)
    ref = jfl.fused_layer_norm(jx, jg, jb, jr if with_res else None,
                               eps=1e-5, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=rtol, atol=atol)
    # the per-row statistics the kernel also writes, (nb, 8, br) tiles
    _, jmean, jrstd = jfl._norm_fwd_pallas(
        jx, jr if with_res else None, jg.reshape(1, -1), jb.reshape(1, -1),
        None, 1e-5, 0.0, False, True)
    np.testing.assert_allclose(_np(mean), _np(jmean[:, 0, :]).reshape(-1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(rstd), _np(jrstd[:, 0, :]).reshape(-1),
                               rtol=1e-5, atol=1e-5)
    if xdt == "float32":
        # the eager JAX composition (the op's route off the kernel) too
        eager = jfl.fused_layer_norm_reference(
            jx, jg, jb, jr if with_res else None, eps=1e-5)
        np.testing.assert_allclose(_np(out), _np(eager), rtol=1e-5,
                                   atol=1e-5)


def test_layer_norm_any_row_count_and_width():
    """The TPU's rows % 8 and D % 128 gates are gone: 3 x 5 x 100."""
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(3, 5, 100).astype(np.float32))
    g = torch.from_numpy(rs.randn(100).astype(np.float32))
    b = torch.from_numpy(rs.randn(100).astype(np.float32))
    out = fused_layer_norm(x, g, b, x, eps=1e-5)
    ref = jfl.fused_layer_norm_reference(
        jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(b.numpy()), jnp.asarray(x.numpy()), eps=1e-5)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


def test_layer_norm_ops_route_cpu_tensors_to_plain_version():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(4, 64).astype(np.float32))
    r = torch.from_numpy(rs.randn(4, 64).astype(np.float32))
    g = torch.ones(64)
    b = torch.zeros(64)
    before = fused_layer_norm.launches
    a = pnn.layer_norm(x, g, b, eps=1e-5)
    c = pnn.fused_layer_norm_op(x, g, b, r, eps=1e-5)
    assert fused_layer_norm.launches == before          # no kernel launch
    assert torch.equal(a, fused_layer_norm_reference(x, g, b, eps=1e-5))
    assert torch.equal(c, fused_layer_norm_reference(x, g, b, r, eps=1e-5))
    np.testing.assert_allclose(
        _np(a), _np(torch.nn.functional.layer_norm(x, (64,), g, b, 1e-5)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# bias + GELU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt,bdt,rtol,atol", [
    # f32: erf of the same f32 argument in two libraries
    ("float32", "float32", 1e-6, 1e-6),
    ("bfloat16", "bfloat16", BF16_RTOL, 1e-6),
    ("bfloat16", "float32", BF16_RTOL, 1e-6),
])
def test_bias_gelu_plain_matches_jax_kernel(xdt, bdt, rtol, atol):
    rs = np.random.RandomState(4)
    x = (2.0 * rs.randn(16, 384)).astype(np.float32)
    b = rs.randn(384).astype(np.float32)
    jx, tx = _pair(x, xdt)
    jb, tb = _pair(b, bdt)
    out = fused_bias_gelu_reference(tx, tb)
    assert out.dtype == tx.dtype
    ref = jfl.fused_bias_gelu(jx, jb, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=rtol, atol=atol)
    before = fused_bias_gelu.launches
    assert torch.equal(pnn.fused_bias_gelu_op(tx, tb), out)
    assert fused_bias_gelu.launches == before


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------

FLASH_TOL = {
    # f32: the same products summed in another order, exp2 in two
    # libraries
    "float32": (2e-5, 2e-5),
    # bf16: P rounds to bf16 against the final row max in the plain
    # version and, at L = 1024, against the running max in the streaming
    # kernel; the output then rounds once more: two ulps of the output,
    # whose entries are averages of V rows of order 1
    "bfloat16": (2.0 ** -6, 2.0 ** -7),
}


def _qkv(b, h, lq, lk, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, lq, d).astype(np.float32),
            rs.randn(b, h, lk, d).astype(np.float32),
            rs.randn(b, h, lk, d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [128, 1024])
def test_flash_plain_matches_jax_kernel(seq, dtype, causal):
    """L = 128 takes the whole-head kernel (``:552``), L = 1024 the
    streaming one (``:590``, 512-blocks over a 2 x 2 grid)."""
    q, k, v = _qkv(1, 2, seq, seq, 64, seed=seq + causal)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and lse.shape == (2, seq)
    assert lse.dtype == torch.float32
    scale = 1.0 / np.sqrt(64)
    ref = jax_flash(jq, jk, jv, scale=scale, causal=causal, interpret=True)
    rtol, atol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), rtol=rtol, atol=atol)
    _, jlse = jax_flash_fwd(jq, jk, jv, scale, causal, interpret=True)
    # the TPU's (bh, nq, 8, bq) sublane tile -> (bh, Lq)
    jlse = _np(jlse)[:, :, 0, :].reshape(2, seq)
    np.testing.assert_allclose(_np(lse), jlse, rtol=1e-5, atol=1e-4)
    if dtype == "float32":
        dense = jattn._sdpa_reference(jq, jk, jv, None, scale, causal)
        np.testing.assert_allclose(_np(out), _np(dense), rtol=2e-5,
                                   atol=2e-5)


def test_flash_blhd_layout_and_ragged_shapes():
    """blhd equals bhld transposed; Lq != Lk, L not a multiple of 128
    and a head dim of 40 are taken."""
    q, k, v = _qkv(2, 3, 77, 200, 40, seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    t = (lambda a: a.transpose(1, 2).contiguous())
    out2, lse2 = flash_attention_fwd(t(tq), t(tk), t(tv), causal=True,
                                     layout="blhd")
    np.testing.assert_allclose(_np(out2.transpose(1, 2)), _np(out),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(lse2), _np(lse), rtol=1e-6, atol=1e-6)
    dense = jattn._sdpa_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, 1 / np.sqrt(40),
                                  True)
    np.testing.assert_allclose(_np(out), _np(dense), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_on_fused_qkv_views_matches_jax_kernel(dtype):
    """q, k and v as MultiHeadAttention hands them over: (B, L, H, D)
    views into one (B, L, 3*H*D) QKV output ("blhd", sequence stride
    3*H*D, k and v offset by H*D and 2*H*D), against the Pallas kernel
    on the same values in (B, H, L, D)."""
    b, l, h, d = 2, 128, 2, 64
    rs = np.random.RandomState(11)
    qkv = rs.randn(b, l, 3 * h * d).astype(np.float32)
    parts = [qkv[..., i * h * d:(i + 1) * h * d].reshape(b, l, h, d)
             .transpose(0, 2, 1, 3) for i in range(3)]
    jq, jk, jv = (_pair(np.ascontiguousarray(p), dtype)[0] for p in parts)
    tqkv = _pair(qkv, dtype)[1]
    tq, tk, tv = (t.view(b, l, h, d) for t in tqkv.split(h * d, dim=-1))
    out, lse = flash_attention_fwd(tq, tk, tv, layout="blhd")
    assert out.shape == (b, l, h, d)
    scale = 1.0 / np.sqrt(d)
    ref = jax_flash(jq, jk, jv, scale=scale, interpret=True)
    rtol, atol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(ref),
                               rtol=rtol, atol=atol)
    _, jlse = jax_flash_fwd(jq, jk, jv, scale, False, interpret=True)
    jlse = _np(jlse)[:, :, 0, :].reshape(b * h, l)
    np.testing.assert_allclose(_np(lse), jlse, rtol=1e-5, atol=1e-4)


def test_flash_rows_with_no_visible_key_give_zero_and_floor_lse():
    from mxnet_tpu_torch.kernels.flash import NO_KEY_LSE, _reference

    q, k, v = _qkv(1, 2, 20, 20, 16, seed=8)
    out, lse = _reference(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), 0.25, True, -5, "bhld")
    assert torch.count_nonzero(out[:, :, :5]) == 0
    assert torch.all(lse[:, :5] == NO_KEY_LSE)
    assert torch.isfinite(out).all() and torch.all(lse[:, 5:] > -1e29)


def test_flash_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 8, 4, 16, seed=9))
    with pytest.raises(MXNetError, match="causal"):
        flash_attention(q, k, v, causal=True)        # Lq > Lk
    with pytest.raises(MXNetError):
        flash_attention(q, k[:, :1], v[:, :1])        # heads disagree
    with pytest.raises(MXNetError):
        flash_attention(q, k, v, layout="bshd")
    before = flash_attention.launches
    flash_attention(q, k, v)                         # CPU: plain version
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# sdp_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_sdp_attention_with_mask_matches_jax(layout):
    q, k, v = _qkv(2, 2, 12, 12, 16, seed=10)
    mask = np.ones((2, 1, 1, 12), np.float32)
    mask[1, ..., 7:] = 0
    if layout == "blhd":
        q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    out = pattn.sdp_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              torch.from_numpy(mask), layout=layout)
    ref = jattn.sdp_attention(None, *(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(mask), layout=layout)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    # the port's dense reference is the JAX one
    own = pattn._sdpa_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(mask), 0.25, False,
                                layout=layout)
    np.testing.assert_allclose(_np(own), _np(ref), rtol=1e-5, atol=1e-5)


def test_sdp_attention_without_mask_takes_flash_and_matches_jax():
    q, k, v = _qkv(1, 2, 16, 24, 8, seed=11)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    for causal in (False, True):
        out = pattn.sdp_attention(*t, causal=causal)
        assert torch.equal(out, flash_attention(*t, causal=causal))
        ref = jattn.sdp_attention(None, *j, causal=causal)
        np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5,
                                   atol=2e-5)
    # causal with Lq > Lk: the kernel rejects it, the dense path serves it
    out = pattn.sdp_attention(t[1], t[0], t[0], causal=True)
    ref = jattn.sdp_attention(None, j[1], j[0], j[0], causal=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


def test_dropout_above_zero_raises_on_every_entry_point():
    """Each entry point takes dropout now. The kernel-level functions
    raise without a seed (as the JAX kernels do) and drop with one; the
    op-level ones draw their seed only in training mode and are the
    identity outside it."""
    from mxnet_tpu_torch import autograd, random_state
    from mxnet_tpu_torch.kernels.dropout import hash_u32

    x = torch.ones(2, 8)
    g = torch.ones(8)
    q = torch.ones(1, 1, 4, 8)
    for fn, args in ((fused_layer_norm, (x, g, g)),
                     (fused_layer_norm_reference, (x, g, g)),
                     (flash_attention, (q, q, q)),
                     (flash_attention_reference, (q, q, q))):
        with pytest.raises(MXNetError, match="requires a seed"):
            fn(*args, dropout=0.1)
    assert not torch.equal(fused_layer_norm(x + torch.arange(8.0), g, g,
                                            dropout=0.5, seed=3),
                           fused_layer_norm(x + torch.arange(8.0), g, g))
    assert torch.equal(flash_attention(q, q, q, dropout=0.5, seed=3),
                       flash_attention_reference(q, q, q, dropout=0.5,
                                                 seed=3)[0])
    # op level: the identity in predict mode, one drawn seed in training
    assert torch.equal(pnn.fused_layer_norm_op(x, g, g, x, dropout=0.1),
                       fused_layer_norm(x, g, g, x))
    assert torch.equal(pattn.sdp_attention(q, q, q, dropout=0.1),
                       flash_attention(q, q, q))
    with autograd.train_mode(), random_state.scoped_seed(9):
        ln = pnn.fused_layer_norm_op(x, g, g, x, dropout=0.1)
        att = pattn.sdp_attention(q, q, q, dropout=0.1)
    assert torch.equal(ln, fused_layer_norm(x, g, g, x, dropout=0.1,
                                            seed=hash_u32(0, 9)))
    assert torch.equal(att, flash_attention(q, q, q, dropout=0.1,
                                            seed=hash_u32(1, 9)))
