"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the Llama-3-8B and BERT serving paths' shapes, the BERT
pretraining path's (backward kernels and the Adam sweep), its dropout
modes (the hash-dropout kernel, LayerNorm and flash attention with
dropout, each with its mask held bit for bit), the Llama pretraining
path's (the RMSNorm backward, RMSNorm under autograd, the AdamW scan and
sweep), the ResNet training path's (the SGD sweep; the ResNet forward
with cuDNN against the CPU), and at ragged ones.

Marked ``cuda``: each test skips where there is no CUDA card (the CPU
test runs) and runs on a machine with one. This file imports neither JAX
nor the JAX package, so it also runs where they are not installed:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``--noconftest`` skips tests/conftest.py, whose seeding fixture imports
the JAX package.)
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import (adam_sweep_reference,
                                     adamw_sweep_reference, flash_attention,
                                     flash_attention_bwd,
                                     flash_attention_bwd_reference,
                                     flash_attention_fwd,
                                     flash_attention_reference,
                                     fused_adam_sweep, fused_adamw_sweep,
                                     fused_bias_gelu,
                                     fused_bias_gelu_bwd,
                                     fused_bias_gelu_bwd_reference,
                                     fused_bias_gelu_reference,
                                     fused_layer_norm, fused_layer_norm_bwd,
                                     fused_layer_norm_bwd_reference,
                                     fused_layer_norm_reference,
                                     fused_rms_norm, fused_rms_norm_bwd,
                                     fused_rms_norm_bwd_reference,
                                     fused_rms_norm_reference,
                                     fused_sgd_sweep, hash_dropout,
                                     hash_dropout_bwd,
                                     hash_dropout_reference,
                                     paged_attention_kernel,
                                     paged_attention_reference,
                                     sgd_sweep_reference)
from mxnet_tpu_torch.kernels.dropout import dropout_thresh, row_keep_mask
from mxnet_tpu_torch.kernels.flash import (NO_KEY_LSE, _bwd_reference,
                                           _launch, _launch_bwd, _reference)

# bf16 keeps 8 significant bits, so one ulp is at most 2**-7 of a
# value's magnitude. The kernel and its plain version sum the squares in
# another order; a last-bit change of rstd can flip the rounding of
# xhat to bf16 (one ulp), and a bf16 output rounds once more: at most
# two ulps where the output is bf16, one where it is f32
BF16_RTOL = 2.0 ** -7
BF16_OUT_RTOL = 2.0 ** -6


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")



@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8, 4096), (4096, 4096), (5, 100)])
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_rms_kernel_matches_plain_on_card(rows, d, xdt, wdt):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, device="cuda", generator=g).to(
        getattr(torch, xdt))
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(
        getattr(torch, wdt))
    before = fused_rms_norm.launches
    out = fused_rms_norm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert fused_rms_norm.launches == before + 1
    ref = fused_rms_norm_reference(x, w, eps=1e-5)
    assert out.dtype == ref.dtype
    rtol = (1e-5 if xdt == "float32" else
            BF16_OUT_RTOL if wdt == "bfloat16" else BF16_RTOL)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [128, 64])
def test_paged_kernel_matches_plain_on_card(b, dtype, d):
    _require_card()
    h, kv, ps, max_len = 32, 8, 16, 1024
    g = torch.Generator(device="cuda").manual_seed(b)
    rs = np.random.RandomState(b)
    lengths = rs.randint(1, max_len + 1, size=b).astype(np.int32)
    lengths[0] = 0
    width = max_len // ps
    perm = rs.permutation(np.arange(1, 1 + b * width)).astype(np.int32)
    table = perm.reshape(b, width)
    n_slots = (1 + b * width) * ps
    tdt = getattr(torch, dtype)
    q = torch.randn(b, h, 1, d, device="cuda", generator=g).to(tdt)
    k = torch.randn(n_slots, kv, d, device="cuda", generator=g).to(tdt)
    v = torch.randn(n_slots, kv, d, device="cuda", generator=g).to(tdt)
    pt = torch.from_numpy(table).cuda()
    ln = torch.from_numpy(lengths).cuda()
    scale = 1.0 / np.sqrt(d)
    out = paged_attention_kernel(q, k, v, pt, ln, page_size=ps, scale=scale)
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, k, v, pt, ln, page_size=ps,
                                    scale=scale)
    assert torch.count_nonzero(out[0]) == 0
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32 * 512, 768), (7, 100), (5, 8192)])
@pytest.mark.parametrize("xdt,gdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("with_res", [True, False])
def test_layer_norm_kernel_matches_plain_on_card(rows, d, xdt, gdt,
                                                 with_res):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    xt, gt = getattr(torch, xdt), getattr(torch, gdt)
    x = (2 + torch.randn(rows, d, device="cuda", generator=g)).to(xt)
    r = torch.randn(rows, d, device="cuda", generator=g).to(xt) \
        if with_res else None
    gamma = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    beta = (0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    before = fused_layer_norm.launches
    out, mean, rstd = fused_layer_norm(x, gamma, beta, r, eps=1e-5,
                                       return_stats=True)
    torch.cuda.synchronize()
    assert fused_layer_norm.launches == before + 1
    ref, rmean, rrstd = fused_layer_norm_reference(x, gamma, beta, r,
                                                   eps=1e-5,
                                                   return_stats=True)
    assert out.dtype == x.dtype
    # f32: statistics summed in another order; bf16: one rounding of the
    # f32 result, which may sit on either side of a rounding boundary
    rtol = 1e-5 if xdt == "float32" else BF16_RTOL
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32 * 512, 3072), (9, 100), (3, 8)])
@pytest.mark.parametrize("xdt,bdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_bias_gelu_kernel_matches_plain_on_card(rows, d, xdt, bdt):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows * d)
    x = (2 * torch.randn(rows, d, device="cuda", generator=g)).to(
        getattr(torch, xdt))
    b = torch.randn(d, device="cuda", generator=g).to(getattr(torch, bdt))
    before = fused_bias_gelu.launches
    out = fused_bias_gelu(x, b)
    torch.cuda.synchronize()
    assert fused_bias_gelu.launches == before + 1
    ref = fused_bias_gelu_reference(x, b)
    # the same f32 arithmetic (erff on the card, erf in torch)
    rtol = 1e-6 if xdt == "float32" else BF16_RTOL
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-6)


# flash attention: f32 differs in the order of f32 sums; bf16 rounds P
# to bf16 against the running row max in the kernel and against the
# final one in the plain version, then rounds the output once more
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -6, 2.0 ** -7)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (B, H, Lq, Lk, D, causal, layout)
    (32, 12, 512, 512, 64, False, "bhld"),      # BERT-base seq 512
    (8, 12, 128, 128, 64, False, "blhd"),
    (2, 8, 2048, 2048, 128, True, "bhld"),      # the streaming case
    (2, 3, 77, 200, 40, True, "bhld"),          # ragged L and D
    (1, 2, 100, 33, 256, False, "blhd"),
    (3, 2, 50, 50, 8, True, "blhd"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(shape, dtype):
    _require_card()
    b, h, lq, lk, d, causal, layout = shape
    g = torch.Generator(device="cuda").manual_seed(lq * d)
    qs = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
    ks = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
    tdt = getattr(torch, dtype)
    q = torch.randn(*qs, device="cuda", generator=g).to(tdt)
    k = torch.randn(*ks, device="cuda", generator=g).to(tdt)
    v = torch.randn(*ks, device="cuda", generator=g).to(tdt)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, layout=layout)
    torch.cuda.synchronize()
    ref, rlse = flash_attention_reference(q, k, v, causal=causal,
                                          layout=layout)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert lse.shape == (b * h, lq) and lse.dtype == torch.float32
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_rows_with_no_visible_key_on_card(dtype):
    """A causal offset below zero leaves the first rows no key: zeros and
    the -1e30 lse, as in the Pallas kernels."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(2, 2, 70, 64, device="cuda", generator=g).to(tdt)
               for _ in range(3))
    out, lse = _launch(q, k, v, 0.125, True, -10, "bhld")
    torch.cuda.synchronize()
    ref, rlse = _reference(q, k, v, 0.125, True, -10, "bhld")
    assert torch.count_nonzero(out[:, :, :10]) == 0
    assert torch.all(lse[:, :10] == NO_KEY_LSE)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d", [(32, 512, 12, 64),      # BERT-base
                                     (3, 77, 5, 40),
                                     (2, 130, 2, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_on_fused_qkv_views_on_card(b, l, h, d, dtype):
    """The heads as MultiHeadAttention hands them over: (B, L, H, D)
    views into one (B, L, 3*H*D) QKV output, with a sequence stride of
    3*H*D and k and v starting H*D and 2*H*D elements in."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(l * d)
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=g).to(
        getattr(torch, dtype))
    q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
    assert q.stride(1) == 3 * h * d and v.storage_offset() == 2 * h * d
    out, lse = flash_attention_fwd(q, k, v, layout="blhd")
    torch.cuda.synchronize()
    ref, rlse = flash_attention_reference(q, k, v, layout="blhd")
    assert out.shape == (b, l, h, d) and out.is_contiguous()
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the pretraining path: backward kernels and the Adam sweep
# ---------------------------------------------------------------------------

# backward kernels against their plain versions, as max |kernel - plain|
# over max |plain|. f32: sums in other orders. bf16: the kernel rounds P
# and dS to bf16 from f32 values summed in another order than the plain
# version's, so a value near a rounding boundary may round the other
# way, and each gradient rounds once more: two ulps of the largest
# magnitude
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _close_to_max(got, want, tol, what=""):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    assert torch.isfinite(got).all(), what
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (B, H, Lq, Lk, D, causal, layout)
    (2, 8, 2048, 2048, 128, True, "bhld"),      # the streaming case
    (2, 3, 77, 200, 40, True, "bhld"),          # ragged L and D
    (2, 3, 130, 70, 64, False, "blhd"),
    (3, 2, 50, 50, 8, True, "blhd"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain_on_card(shape, dtype):
    _require_card()
    b, h, lq, lk, d, causal, layout = shape
    g = torch.Generator(device="cuda").manual_seed(lq * d + 1)
    qs = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
    ks = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
    tdt = getattr(torch, dtype)
    q, do = (torch.randn(*qs, device="cuda", generator=g).to(tdt)
             for _ in range(2))
    k, v = (torch.randn(*ks, device="cuda", generator=g).to(tdt)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, layout=layout)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              layout=layout)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                         layout=layout)
    for name, x, y, like in zip("qkv", got, want, (q, k, v)):
        assert x.shape == like.shape and x.dtype == like.dtype
        assert x.is_contiguous()
        _close_to_max(x, y, BWD_TOL[dtype], f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_on_fused_qkv_views_on_card(dtype):
    """BERT-base's heads as (B, L, H, D) views of one (B, L, 3*H*D)
    projection output, through autograd: the gradient of the whole
    projection output against the plain backward's."""
    _require_card()
    b, l, h, d = 32, 512, 12, 64
    g = torch.Generator(device="cuda").manual_seed(17)
    tdt = getattr(torch, dtype)
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=g).to(tdt)
    do = torch.randn(b, l, h, d, device="cuda", generator=g).to(tdt)
    leaf = qkv.clone().requires_grad_()
    q, k, v = (t.view(b, l, h, d) for t in leaf.split(h * d, dim=-1))
    before = flash_attention_bwd.launches
    flash_attention(q, k, v, layout="blhd").backward(do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
    o, lse = flash_attention_fwd(q, k, v, layout="blhd")
    want = torch.cat([t.reshape(b, l, h * d) for t in
                      flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                    layout="blhd")], -1)
    _close_to_max(leaf.grad, want, BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_rows_with_no_visible_key_on_card(dtype):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(6)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(2, 2, 70, 64, device="cuda", generator=g)
                   .to(tdt) for _ in range(4))
    o, lse = _launch(q, k, v, 0.125, True, -10, "bhld")
    got = _launch_bwd(q, k, v, o, lse, do, 0.125, True, -10, "bhld")
    torch.cuda.synchronize()
    want = _bwd_reference(q, k, v, o, lse, do, 0.125, True, -10, "bhld")
    assert torch.count_nonzero(got[0][:, :, :10]) == 0
    for x, y in zip(got, want):
        _close_to_max(x, y, BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32 * 512, 768), (7, 100), (5, 8192),
                                    (3, 3000)])
@pytest.mark.parametrize("xdt,gdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("with_res", [True, False])
def test_layer_norm_bwd_kernel_matches_plain_on_card(rows, d, xdt, gdt,
                                                     with_res):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows + d + 1)
    xt, gt = getattr(torch, xdt), getattr(torch, gdt)
    x = (2 + torch.randn(rows, d, device="cuda", generator=g)).to(xt)
    r = torch.randn(rows, d, device="cuda", generator=g).to(xt) \
        if with_res else None
    gamma = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    beta = (0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(xt)
    _, mean, rstd = fused_layer_norm(x, gamma, beta, r, return_stats=True)
    before = fused_layer_norm_bwd.launches
    got = fused_layer_norm_bwd(x, gamma, mean, rstd, dy, r)
    torch.cuda.synchronize()
    assert fused_layer_norm_bwd.launches == before + 1
    want = fused_layer_norm_bwd_reference(x, gamma, mean, rstd, dy, r)
    # dx: one rounding of f32 sums taken in another order; dgamma/dbeta:
    # f32 column sums over the rows in another order, rounded once
    tol = 1e-5 if xdt == "float32" and gdt == "float32" else 2.0 ** -7
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        assert a.dtype == b.dtype
        _close_to_max(a, b, tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32 * 512, 3072), (9, 100), (3, 8)])
@pytest.mark.parametrize("xdt,bdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_bias_gelu_bwd_kernel_matches_plain_on_card(rows, d, xdt, bdt):
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows * d + 1)
    x = (2 * torch.randn(rows, d, device="cuda", generator=g)).to(
        getattr(torch, xdt))
    b = torch.randn(d, device="cuda", generator=g).to(getattr(torch, bdt))
    dy = torch.randn(rows, d, device="cuda", generator=g).to(x.dtype)
    before = fused_bias_gelu_bwd.launches
    got = fused_bias_gelu_bwd(x, b, dy)
    torch.cuda.synchronize()
    assert fused_bias_gelu_bwd.launches == before + 1
    want = fused_bias_gelu_bwd_reference(x, b, dy)
    tol = 1e-5 if xdt == "float32" and bdt == "float32" else 2.0 ** -7
    for name, a, c in zip(("dx", "db"), got, want):
        assert a.dtype == c.dtype
        _close_to_max(a, c, tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,gdt,mp", [("float32", "float32", False),
                                        ("float32", "bfloat16", True),
                                        ("bfloat16", "bfloat16", False)])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_sweep_kernel_bit_identical_on_card(wdt, gdt, mp, clip):
    """The sweep kernel against its plain version, bit for bit, over
    members of ragged sizes (below one 4096-element chunk, an empty one,
    exactly one chunk, one past it, BERT-base's word embedding)."""
    _require_card()
    sizes = [5, 0, 4096, 4097, 30522 * 768, 768]

    def members():
        g = torch.Generator(device="cuda").manual_seed(3)
        ws = [torch.randn(n, device="cuda", generator=g).to(
            getattr(torch, wdt)) for n in sizes]
        gs = [torch.randn(n, device="cuda", generator=g).to(
            getattr(torch, gdt)) for n in sizes]
        ms = [0.1 * torch.randn(n, device="cuda", generator=g).to(
            getattr(torch, wdt)) for n in sizes]
        vs = [torch.rand(n, device="cuda", generator=g).to(
            getattr(torch, wdt)) for n in sizes]
        lows = [w.to(torch.bfloat16) for w in ws] if mp else None
        return ws, gs, ms, vs, lows

    lrs = [1e-4 * (1 + j) for j in range(len(sizes))]
    wds = [0.0, 0.0, 0.01, 0.0, 0.02, 0.0]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5,
              clip_gradient=clip)
    a, b = members(), members()
    before = fused_adam_sweep.launches
    for _ in range(2):
        fused_adam_sweep(*a, lrs, wds, **kw)
        adam_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    assert fused_adam_sweep.launches == before + 2
    for grp in range(5 if mp else 4):
        for x, y in zip(a[grp], b[grp]):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_trainstep_on_card_matches_cpu():
    """Three f32 TrainStep Adam steps of a narrow 2-layer
    BERTForPretrainFused on the card (every backward kernel and the
    sweep) against the same model and batch on the CPU (the plain
    versions): the losses to 1e-5 relative."""
    _require_card()
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    torch.backends.cuda.matmul.allow_tf32 = False
    net = BERTForPretrainFused(vocab_size=512, max_length=128,
                               num_layers=2, units=64, hidden_size=128,
                               num_heads=4, dropout=0.0, chunk=128,
                               ctx=mx.cpu(),
                               generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(net).cuda()
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 512, (4, 128))
    lab = rs.randint(0, 512, (4, 128))
    losses = []
    for model in (net, card):
        step = mx.parallel.TrainStep(model, lambda o, *a: o, "adam",
                                     loss_only=True,
                                     optimizer_params={"learning_rate": 1e-3})
        before = fused_adam_sweep.launches
        losses.append([float(step((tok, lab), ())[0]) for _ in range(3)])
    assert fused_adam_sweep.launches == before + 3
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


# ---------------------------------------------------------------------------
# the dropout modes: hash dropout, LayerNorm and flash attention
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,axes", [((32, 512, 768), ()),
                                        ((7, 13), ()),
                                        ((4, 6, 40), (1,)),
                                        ((3, 5, 7, 9), (0, 2))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_kernel_bit_identical_on_card(shape, axes, dtype):
    """The Dropout kernel and its backward against the plain version:
    the same bits (the same integer hash, one rounding of the same
    product in the data's dtype), so the zero pattern is the mask."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(len(shape))
    x = torch.randn(*shape, device="cuda", generator=g).to(
        getattr(torch, dtype))
    seed = 0xC0FFEE + len(shape)
    before = hash_dropout.launches, hash_dropout_bwd.launches
    leaf = x.clone().requires_grad_()
    out = hash_dropout(leaf, 0.1, seed, axes)
    out.backward(x)
    torch.cuda.synchronize()
    assert (hash_dropout.launches, hash_dropout_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = hash_dropout_reference(x, 0.1, seed, axes)
    assert out.dtype == x.dtype
    assert torch.equal(out.detach(), want)
    assert torch.equal(out.detach() == 0, want == 0)
    assert torch.equal(leaf.grad, want)
    if x.numel() > 10 ** 6:
        assert 0.09 < float((want == 0).float().mean()) < 0.11


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(32 * 512, 768), (7, 100), (5, 8192)])
@pytest.mark.parametrize("xdt,gdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("with_res", [True, False])
def test_layer_norm_dropout_kernels_match_plain_on_card(rows, d, xdt, gdt,
                                                        with_res):
    """LN(dropout(x) + res) forward and backward at p = 0.1 against the
    plain versions (the tolerances of the dropout-free tests above); the
    zeros of dx are the mask of the element's flat (row, col) id, bit for
    bit, and the residual's gradient comes out separately."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(rows + d + 2)
    xt, gt = getattr(torch, xdt), getattr(torch, gdt)
    x = (2 + torch.randn(rows, d, device="cuda", generator=g)).to(xt)
    r = torch.randn(rows, d, device="cuda", generator=g).to(xt) \
        if with_res else None
    gamma = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    beta = (0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(xt)
    seed = 1234 + rows
    before = (fused_layer_norm.dropout_launches,
              fused_layer_norm_bwd.dropout_launches)
    out, mean, rstd = fused_layer_norm(x, gamma, beta, r, dropout=0.1,
                                       seed=seed, return_stats=True)
    got = fused_layer_norm_bwd(x, gamma, mean, rstd, dy, r, 0.1, seed)
    torch.cuda.synchronize()
    assert (fused_layer_norm.dropout_launches,
            fused_layer_norm_bwd.dropout_launches) == \
        (before[0] + 1, before[1] + 1)
    ref, rmean, rrstd = fused_layer_norm_reference(
        x, gamma, beta, r, dropout=0.1, seed=seed, return_stats=True)
    rtol = 1e-5 if xdt == "float32" else BF16_RTOL
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(mean, rmean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-5)
    want = fused_layer_norm_bwd_reference(x, gamma, mean, rstd, dy, r, 0.1,
                                          seed)
    assert len(got) == len(want) == (4 if with_res else 3)
    tol = 1e-5 if xdt == "float32" and gdt == "float32" else 2.0 ** -7
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dres"), got, want):
        assert a.dtype == b.dtype
        _close_to_max(a, b, tol, name)
    keep = row_keep_mask(rows, d, seed, dropout_thresh(0.1), "cuda")
    assert torch.equal(got[0] != 0, keep)
    assert torch.equal(want[0] != 0, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (B, H, Lq, Lk, D, causal, layout)
    (32, 12, 512, 512, 64, False, "blhd"),      # BERT-base, QKV views
    (2, 8, 2048, 2048, 128, True, "bhld"),      # the streaming case
    (2, 3, 77, 200, 40, True, "bhld"),          # ragged L and D
    (3, 2, 50, 50, 8, False, "blhd"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dropout_kernels_match_plain_on_card(shape, dtype):
    """Flash forward and backward at p = 0.1 against the plain versions
    (forward: FLASH_TOL and the lse to 1e-5, which dropout does not
    touch; backward: BWD_TOL); "blhd" at BERT's shape takes the heads as
    views of one fused QKV output."""
    _require_card()
    b, h, lq, lk, d, causal, layout = shape
    g = torch.Generator(device="cuda").manual_seed(lq * d + 3)
    tdt = getattr(torch, dtype)
    if layout == "blhd" and lq == lk:
        qkv = torch.randn(b, lq, 3 * h * d, device="cuda",
                          generator=g).to(tdt)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.split(h * d, dim=-1))
    else:
        qs = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
        ks = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
        q = torch.randn(*qs, device="cuda", generator=g).to(tdt)
        k, v = (torch.randn(*ks, device="cuda", generator=g).to(tdt)
                for _ in range(2))
    do = torch.randn(q.shape, device="cuda", generator=g).to(tdt)
    kw = dict(causal=causal, layout=layout, dropout=0.1, seed=99 + lq)
    before = (flash_attention.dropout_launches,
              flash_attention_bwd.dropout_launches)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.dropout_launches,
            flash_attention_bwd.dropout_launches) == \
        (before[0] + 1, before[1] + 1)
    ref, rlse = flash_attention_reference(q, k, v, **kw)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    for name, x, y in zip("qkv", got, want):
        _close_to_max(x, y, BWD_TOL[dtype], f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dropout_mask_is_bit_identical_on_card(d, dtype):
    """With lk = d and V the identity, O is the dropped, normalised P,
    so its zeros are the mask: the kernel's zeros must be the plain
    version's, element for element (scores are small, so no kept P is
    0)."""
    _require_card()
    b, h, lq = 4, 12, 512
    g = torch.Generator(device="cuda").manual_seed(d)
    tdt = getattr(torch, dtype)
    q = (0.1 * torch.randn(b, h, lq, d, device="cuda", generator=g)).to(tdt)
    k = (0.1 * torch.randn(b, h, d, d, device="cuda", generator=g)).to(tdt)
    v = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous().to(tdt)
    out, _ = flash_attention_fwd(q, k, v, dropout=0.1, seed=7 + d)
    torch.cuda.synchronize()
    ref, _ = flash_attention_reference(q, k, v, dropout=0.1, seed=7 + d)
    assert torch.equal(out == 0, ref == 0)
    assert 0.08 < float((ref == 0).float().mean()) < 0.12


# ---------------------------------------------------------------------------
# the Llama pretraining path: the RMSNorm backward and the AdamW sweep
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8, 4096), (16384, 2048), (5, 100)])
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_rms_forward_with_rstd_on_card(rows, d, xdt, wdt):
    """The forward that also writes the f32 row rstd gives the same output
    as the one that does not, and its rstd matches the plain version's
    (f32 sums of squares in another order)."""
    _require_card()
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    g = torch.Generator(device="cuda").manual_seed(rows + d + 2)
    x = torch.randn(rows, d, device="cuda", generator=g).to(
        getattr(torch, xdt))
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(
        getattr(torch, wdt))
    before = fused_rms_norm.launches
    plain_out = fused_rms_norm(x, w, eps=1e-5)
    out, rstd = _rms_norm_fwd(x, w, 1e-5, True)
    torch.cuda.synchronize()
    assert fused_rms_norm.launches == before + 2
    assert torch.equal(out, plain_out)
    _, ref = fused_rms_norm_reference(x, w, eps=1e-5, return_rstd=True)
    assert rstd.shape == (rows,) and rstd.dtype == torch.float32
    torch.testing.assert_close(rstd, ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(16384, 2048), (8, 4096), (5, 100),
                                    (3, 8192)])
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_rms_bwd_kernel_matches_plain_on_card(rows, d, xdt, wdt):
    """dx and dw of the RMSNorm backward kernel against its plain version
    from the same saved rstd: dx rounds once from f32 values summed in
    another order, dw sums the rows' f32 partials in another order."""
    _require_card()
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    g = torch.Generator(device="cuda").manual_seed(rows * d + 3)
    xt, wt = getattr(torch, xdt), getattr(torch, wdt)
    x = (1.5 * torch.randn(rows, d, device="cuda", generator=g)).to(xt)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(wt)
    _, rstd = _rms_norm_fwd(x, w, 1e-5, True)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(
        torch.promote_types(xt, wt))
    before = fused_rms_norm_bwd.launches
    got = fused_rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert fused_rms_norm_bwd.launches == before + 1
    want = fused_rms_norm_bwd_reference(x, w, rstd, dy)
    tol = 1e-5 if xdt == "float32" and wdt == "float32" else 2.0 ** -7
    for name, a, b in zip(("dx", "dw"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close_to_max(a, b, tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_module_trains_its_weight_on_card(dtype):
    """``RMSNorm(...)(x).sum().backward()`` on the card leaves
    ``weight.grad`` set (the forward kernel alone has no grad_fn) and
    equal to the plain version's on the CPU, and x's gradient too; one
    forward and one backward kernel launch."""
    _require_card()
    from mxnet_tpu_torch.gluon.model_zoo.nlp import RMSNorm

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(9)
    x = (1.5 * torch.randn(4, 64, 2048, generator=g)).to(dt)
    grads = []
    before = (fused_rms_norm.launches, fused_rms_norm_bwd.launches)
    for dev in ("cuda", "cpu"):
        norm = RMSNorm(2048, eps=1e-5, device=dev, dtype=dt)
        with torch.no_grad():
            norm.weight.copy_((1 + 0.1 * torch.randn(2048, generator=g)))
        xi = x.to(dev).requires_grad_()
        norm(xi).float().sum().backward()
        assert norm.weight.grad is not None and xi.grad is not None
        grads.append((xi.grad.cpu(), norm.weight.grad.cpu()))
        g.manual_seed(9)
        torch.randn(4, 64, 2048, generator=g)
    torch.cuda.synchronize()
    assert (fused_rms_norm.launches, fused_rms_norm_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for a, b, name in zip(grads[0], grads[1], ("dx", "dw")):
        _close_to_max(a, b, tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,gdt,mp", [("float32", "float32", False),
                                        ("float32", "bfloat16", True),
                                        ("bfloat16", "bfloat16", False)])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_scan_and_sweep_bit_identical_on_card(wdt, gdt, mp, clip):
    """The AdamW scan and sweep against their plain version, bit for bit,
    over members of ragged sizes (below one 4096-element chunk, an empty
    one, exactly one chunk, one past it, proxy1b's embedding, one
    holding a NaN past its first chunk, one holding an inf): the NaN
    member keeps its weight and moments bit for bit, the inf member too
    without a clip, and is updated with clip 1.0."""
    _require_card()
    sizes = [5, 0, 4096, 4097, 32768 * 2048, 9000, 768]
    nan_j, inf_j = 5, 6

    def members():
        g = torch.Generator(device="cuda").manual_seed(4)
        ws = [torch.randn(n, device="cuda", generator=g).to(
            getattr(torch, wdt)) for n in sizes]
        gs = [torch.randn(n, device="cuda", generator=g).to(
            getattr(torch, gdt)) for n in sizes]
        gs[nan_j][8000] = float("nan")
        gs[inf_j][17] = float("inf")
        ms = [0.1 * torch.randn(n, device="cuda", generator=g)
              for n in sizes]
        vs = [torch.rand(n, device="cuda", generator=g) for n in sizes]
        lows = [w.to(torch.bfloat16) for w in ws] if mp else None
        return ws, gs, ms, vs, lows

    lrs = [3e-4 * (1 + j) for j in range(len(sizes))]
    wds = [0.1, 0.0, 0.1, 0.01, 0.1, 0.1, 0.1]
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-6, rescale_grad=0.5,
              clip_gradient=clip)
    a, b = members(), members()
    start = [t.clone() for t in a[0] + a[2] + a[3]]
    before = (fused_adamw_sweep.launches, fused_adamw_sweep.scan_launches)
    for _ in range(2):
        fused_adamw_sweep(*a, lrs, wds, **kw)
        adamw_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    assert (fused_adamw_sweep.launches, fused_adamw_sweep.scan_launches) \
        == (before[0] + 2, before[1] + 2)
    # the updated groups: weights, moments and the bf16 weights (the
    # grads, one holding a NaN, are inputs)
    for grp in (0, 2, 3, 4) if mp else (0, 2, 3):
        for x, y in zip(a[grp], b[grp]):
            assert torch.equal(x, y)
    n = len(sizes)
    skipped = {nan_j} | ({inf_j} if clip is None else set())
    for j in range(n):
        same = all(torch.equal(a[grp][j], start[k * n + j])
                   for k, grp in enumerate((0, 2, 3)))
        assert same == (j in skipped or sizes[j] == 0), j


@pytest.mark.cuda
def test_llama_trainstep_on_card_matches_cpu():
    """Three f32 AdamW TrainStep steps of a 2-layer llama_tiny with the
    fused CE head on the card (RMSNorm forward and backward, causal flash
    under GQA, the AdamW scan and sweep) against the same model and batch
    on the CPU (the plain versions): the losses to 1e-5 relative."""
    _require_card()
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_tiny

    torch.backends.cuda.matmul.allow_tf32 = False
    net = llama_tiny(fused_ce=True, ctx=mx.cpu(),
                     generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(net).cuda()
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 256, (2, 129))
    batch = ((toks[:, :-1], toks[:, 1:]), ())
    losses = []
    for model in (net, card):
        step = mx.parallel.TrainStep(model, lambda o, *a: o, "adamw",
                                     loss_only=True,
                                     optimizer_params={"learning_rate": 1e-3,
                                                       "wd": 0.1})
        before = (fused_adamw_sweep.launches, fused_rms_norm_bwd.launches)
        losses.append([float(step(*batch)[0]) for _ in range(3)])
    assert (fused_adamw_sweep.launches, fused_rms_norm_bwd.launches) \
        == (before[0] + 3, before[1] + 3 * 5)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("wdt,gdt,mp", [("float32", "float32", False),
                                        ("float32", "bfloat16", True),
                                        ("bfloat16", "bfloat16", False)])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("clip", [None, 1.0])
def test_sgd_sweep_bit_identical_on_card(wdt, gdt, mp, momentum, clip):
    """The SGD sweep against its plain version, bit for bit (compared as
    bits, so NaNs count), over members of ragged sizes (below one
    4096-element chunk, an empty one, exactly one chunk, one past it,
    a channels-last 3x3 convolution weight, ResNet-50's classifier
    weight, one whose grad holds a NaN past its first chunk, one holding
    an inf), with and without momentum (``moms=None``), per-member lr
    and wd and a grad rescale of 0.5; the NaN and inf propagate into
    their members' weights, as the reference's SGD has no overflow skip;
    one launch per call."""
    _require_card()
    shapes = [(5,), (0,), (4096,), (4097,), (256, 128, 3, 3),
              (1000, 2048), (9000,), (768,)]
    nan_j, inf_j = 6, 7
    dt = {n: getattr(torch, n) for n in ("float32", "bfloat16")}

    def members():
        g = torch.Generator(device="cuda").manual_seed(5)

        def rand(shape, dtype, scale=1.0):
            fmt = torch.channels_last if len(shape) == 4 else \
                torch.contiguous_format
            out = torch.empty(shape, device="cuda", memory_format=fmt)
            return (scale * out.normal_(generator=g)).to(dtype)

        ws = [rand(s, dt[wdt]) for s in shapes]
        gs = [rand(s, dt[gdt]) for s in shapes]
        gs[nan_j].view(-1)[8000] = float("nan")
        gs[inf_j].view(-1)[17] = float("inf")
        moms = [rand(s, dt[wdt], 0.1) for s in shapes] if momentum \
            else None
        lows = [w.to(torch.bfloat16) for w in ws] if mp else None
        return ws, gs, moms, lows

    lrs = [0.1 * (1 + j) for j in range(len(shapes))]
    wds = [1e-4, 0.0, 1e-4, 0.01, 5e-4, 1e-4, 0.0, 1e-4]
    kw = dict(momentum=momentum, rescale_grad=0.5, clip_gradient=clip)
    a, b = members(), members()
    before = fused_sgd_sweep.launches
    for _ in range(2):
        fused_sgd_sweep(*a, lrs, wds, **kw)
        sgd_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    assert fused_sgd_sweep.launches == before + 2
    for grp in (0, 2, 3):
        if a[grp] is None:
            continue
        for x, y in zip(a[grp], b[grp]):
            assert x.stride() == y.stride()
            assert torch.equal(_bits(x), _bits(y))
    assert torch.isnan(a[0][nan_j].float()).any()
    # the inf grad makes its weight -inf, then NaN (inf - inf) a step
    # later; clipped, it stays finite
    assert torch.isfinite(a[0][inf_j].float()).all() == (clip is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_forward_on_card_matches_cpu(layout):
    """``resnet18_v1(classes=10)`` at 64x64, f32, with TF32 off in cuDNN:
    the logits on the card against the same model on the CPU, in predict
    and in train mode (batch statistics), within 1e-4 of the largest
    logit (f32 sums in other orders through 20 layers); the train-mode
    forward folds the same running statistics into both (1e-5)."""
    _require_card()
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = resnet18_v1(classes=10, layout=layout, ctx=mx.cpu(),
                          generator=torch.Generator().manual_seed(3))
        card = copy.deepcopy(net).cuda()
        x = torch.from_numpy(np.random.RandomState(3).randn(
            4, 3, 64, 64).astype(np.float32))
        for train in (False, True):
            scope = mx.autograd.train_mode() if train else \
                mx.autograd.predict_mode()
            with torch.no_grad(), scope:
                want = net(x)
                got = card(x.cuda()).cpu()
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (train, err)
        for k, v in net.state_dict().items():
            if "running" in k:
                torch.testing.assert_close(card.state_dict()[k].cpu(), v,
                                           rtol=1e-5, atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
