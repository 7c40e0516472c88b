"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the Llama-3-8B and BERT serving paths' shapes, the BERT
pretraining path's (backward kernels and the Adam sweep), its dropout
modes (the hash-dropout kernel, LayerNorm and flash attention with
dropout, each with its mask held bit for bit), the Llama pretraining
path's (the RMSNorm backward, RMSNorm under autograd, the AdamW scan and
sweep), the ResNet training path's (the SGD sweep; the ResNet forward
with cuDNN against the CPU), the eager Trainer path's (the LAMB sweep),
and at ragged ones.

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
                                     fused_lamb_sweep,
                                     fused_layer_norm, fused_layer_norm_bwd,
                                     fused_layer_norm_bwd_reference,
                                     fused_layer_norm_reference,
                                     fused_rms_norm, fused_rms_norm_bwd,
                                     fused_rms_norm_bwd_reference,
                                     fused_rms_norm_reference,
                                     fused_sgd_sweep, hash_dropout,
                                     hash_dropout_bwd,
                                     hash_dropout_reference,
                                     lamb_sweep_reference,
                                     paged_attention_kernel,
                                     paged_attention_reference,
                                     paged_attention_split_reference,
                                     paged_splits, sgd_sweep_reference)
from mxnet_tpu_torch.kernels._build import kernels_per_call
from mxnet_tpu_torch.kernels.dropout import (attn_keep_mask, dropout_thresh,
                                             row_keep_mask)
from mxnet_tpu_torch.kernels.flash import (NO_KEY_LSE, _bwd_reference,
                                           _launch, _launch_bwd, _reference,
                                           bwd_route, fwd_route)

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


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_paged_kernel_split_edges_on_card(b, dtype, d, group):
    """The split kernel and its combine at the runs' edges: rows of
    length 0, 1, a page, a page and one, a run (a split boundary), a run
    and one, the full table and past it (clamped to the capacity),
    against the plain version and the plain split-and-merge; the same
    bits on a second call, and no host sync (lengths is never read on
    the host)."""
    _require_card()
    kv, ps, width = 4, 16, 64
    h = kv * group
    n_split = paged_splits(b, kv, width, ps, _sm_count())
    run = -(-width // n_split) * ps
    edges = np.array([0, 1, ps, ps + 1, run, run + 1, width * ps,
                      width * ps + 100], np.int32)
    lengths = edges[np.arange(b) % len(edges)] if b > 1 \
        else np.array([run + 1], np.int32)
    g = torch.Generator(device="cuda").manual_seed(b * 100 + d + group)
    rs = np.random.RandomState(b + d + group)
    table = rs.permutation(np.arange(1, 1 + b * width)).astype(
        np.int32).reshape(b, width)
    n_slots = (1 + b * width) * ps
    tdt = getattr(torch, dtype)
    q = torch.randn(b, h, 1, d, device="cuda", generator=g).to(tdt)
    k = torch.randn(n_slots, kv, d, device="cuda", generator=g).to(tdt)
    v = torch.randn(n_slots, kv, d, device="cuda", generator=g).to(tdt)
    pt = torch.from_numpy(table).cuda()
    ln = torch.from_numpy(lengths).cuda()
    scale = 1.0 / np.sqrt(d)
    before = paged_attention_kernel.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged_attention_kernel(q, k, v, pt, ln, page_size=ps,
                                     scale=scale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = paged_attention_kernel(q, k, v, pt, ln, page_size=ps,
                                   scale=scale)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 2
    assert torch.equal(out, again)
    tol = 2e-5 if dtype == "float32" else 1e-2
    ref = paged_attention_reference(q, k, v, pt, ln, page_size=ps,
                                    scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    split = paged_attention_split_reference(q, k, v, pt, ln, page_size=ps,
                                            scale=scale, n_split=n_split)
    torch.testing.assert_close(out.float(), split.float(), rtol=tol,
                               atol=tol)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.count_nonzero(out[i]) == 0


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


def _fwd_routes():
    return (flash_attention.wgmma_launches, flash_attention.mma_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # (B, H, Lq, Lk, D, causal, layout, views)
    (2, 3, 200, 200, 64, False, "bhld", False),   # L not a multiple of 64
    (2, 3, 130, 130, 128, True, "blhd", False),   # nor of 128
    (1, 2, 100, 300, 128, True, "bhld", False),   # causal, lq < lk
    (2, 8, 200, 328, 128, True, "bhld", False),
    (2, 2, 70, 190, 64, True, "blhd", False),
    (1, 2, 257, 129, 64, False, "bhld", False),   # lq > lk
    (2, 4, 1, 77, 128, False, "bhld", False),     # a single query
    (2, 4, 1, 77, 64, True, "blhd", False),
    (1, 2, 129, 1000, 64, False, "bhld", False),  # one warpgroup's rows
    (1, 2, 129, 1000, 128, True, "blhd", False),  # all past lq
    (1, 4, 1000, 1000, 128, False, "blhd", True),  # fused-QKV views
    (3, 2, 190, 190, 64, True, "blhd", True),
    (2, 2, 77, 77, 40, True, "bhld", False),      # the mma route's dims
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_fwd_kernel_tile_edges_on_card(shape, dtype, dropout):
    """The forward at the tiles' edges, on its route (fwd_route: the
    warpgroup kernel for bf16 at head dim 64 or 128, the mma.sync / FMA
    kernel otherwise), against the plain version, with and without P
    dropout (the mask's zeros are the plain version's: with dropout the
    outputs are held to the same tolerance, which a flipped mask bit
    exceeds); the same bits on a second call."""
    _require_card()
    b, h, lq, lk, d, causal, layout, views = shape
    g = torch.Generator(device="cuda").manual_seed(lq * d + lk)
    tdt = getattr(torch, dtype)
    if views:
        qkv = torch.randn(b, lq, 3 * h * d, device="cuda",
                          generator=g).to(tdt)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.split(h * d, dim=-1))
    else:
        qs = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
        ks = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
        q = torch.randn(*qs, device="cuda", generator=g).to(tdt)
        k, v = (torch.randn(*ks, device="cuda", generator=g).to(tdt)
                for _ in range(2))
    kw = dict(causal=causal, layout=layout)
    if dropout:
        kw.update(dropout=dropout, seed=31 + lq + lk)
    route = fwd_route(tdt, d)
    before = _fwd_routes()
    out, lse = flash_attention_fwd(q, k, v, **kw)
    again, lse_again = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    after = _fwd_routes()
    assert after == ((before[0] + 2, before[1]) if route == "wgmma"
                     else (before[0], before[1] + 2))
    assert route == ("wgmma" if dtype == "bfloat16" and d in (64, 128)
                     else "mma")
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    ref, rlse = flash_attention_reference(q, k, v, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.is_contiguous()
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("offset", [-30, -100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_rows_with_no_visible_key_at_tile_edges_on_card(
        d, offset, dtype):
    """A negative causal offset leaves the first -offset rows no visible
    key: zeros and the -1e30 lse. At -100 the warpgroup route's first
    warpgroup (rows 0-63) visits no tile at all."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(70 + d - offset)
    tdt = getattr(torch, dtype)
    q = torch.randn(2, 3, 150, d, device="cuda", generator=g).to(tdt)
    k, v = (torch.randn(2, 3, 170, d, device="cuda", generator=g).to(tdt)
            for _ in range(2))
    out, lse = _launch(q, k, v, d ** -0.5, True, offset, "bhld")
    torch.cuda.synchronize()
    ref, rlse = _reference(q, k, v, d ** -0.5, True, offset, "bhld")
    assert torch.count_nonzero(out[:, :, :-offset]) == 0
    assert torch.all(lse[:, :-offset] == NO_KEY_LSE)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_flash_fwd_dropout_mask_at_tile_edges_on_card(d, layout):
    """The warpgroup forward's mask bit for bit at a ragged Lq: with
    lk = d and V the identity, O is the dropped, normalised P, so its
    zeros are the mask of the absolute (b * H + h, q, k) ids, in either
    layout; the same bits on a second call."""
    _require_card()
    b, h, lq, seed = 2, 3, 200, 555 + d
    g = torch.Generator(device="cuda").manual_seed(d + 1)
    eye = torch.eye(d, device="cuda", dtype=torch.bfloat16)
    if layout == "bhld":
        q = 0.1 * torch.randn(b, h, lq, d, device="cuda", generator=g)
        k = 0.1 * torch.randn(b, h, d, d, device="cuda", generator=g)
        v = eye.expand(b, h, d, d).contiguous()
    else:
        q = 0.1 * torch.randn(b, lq, h, d, device="cuda", generator=g)
        k = 0.1 * torch.randn(b, d, h, d, device="cuda", generator=g)
        v = eye[None, :, None, :].expand(b, d, h, d).contiguous()
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    kw = dict(layout=layout, dropout=0.1, seed=seed)
    out, _ = flash_attention_fwd(q, k, v, **kw)
    again, _ = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    keep = attn_keep_mask(b, h, lq, d, seed, dropout_thresh(0.1), "cuda")
    zeros = out == 0
    if layout == "blhd":
        zeros = zeros.transpose(1, 2)
    assert torch.equal(zeros, ~keep)
    assert torch.equal(out, again)
    assert 0.08 < float((~keep).float().mean()) < 0.12


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
@pytest.mark.parametrize("shape", [
    # (B, H, Lq, Lk, D, causal, layout, views)
    (2, 3, 200, 200, 64, False, "bhld", False),   # L not a multiple of 64
    (2, 3, 130, 130, 128, True, "blhd", False),   # nor of 128
    (1, 2, 100, 300, 128, True, "bhld", False),   # causal, lq < lk
    (2, 2, 70, 190, 64, True, "blhd", False),
    (1, 4, 1000, 1000, 128, False, "blhd", True),  # fused-QKV views
    (3, 2, 190, 190, 64, True, "blhd", True),
    (2, 2, 77, 77, 256, True, "bhld", False),     # head dim 256
    (2, 2, 96, 150, 200, False, "blhd", False),   # 200, padded to 256
    (1, 3, 64, 64, 136, True, "bhld", False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_tile_edges_on_card(shape, dtype):
    """The backward at the tiles' edges, on its route (bwd_route: the
    warpgroup kernels for bf16 at head dim 64 or 128), against the plain
    version; the same bits on a second call."""
    _require_card()
    b, h, lq, lk, d, causal, layout, views = shape
    g = torch.Generator(device="cuda").manual_seed(lq * d + lk)
    tdt = getattr(torch, dtype)
    if views:
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
    o, lse = flash_attention_fwd(q, k, v, causal=causal, layout=layout)
    route = bwd_route(tdt, d)
    before = (flash_attention_bwd.wgmma_launches,
              flash_attention_bwd.mma_launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              layout=layout)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                layout=layout)
    torch.cuda.synchronize()
    after = (flash_attention_bwd.wgmma_launches,
             flash_attention_bwd.mma_launches)
    assert after == ((before[0] + 2, before[1]) if route == "wgmma"
                     else (before[0], before[1] + 2))
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                         layout=layout)
    for name, x, y, z in zip("qkv", got, want, again):
        assert torch.equal(x, z), f"d{name} differs between two calls"
        _close_to_max(x, y, BWD_TOL[dtype], f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_rows_with_no_visible_key_at_tile_edges_on_card(d, dtype):
    """A negative causal offset leaves the first rows no visible key;
    ragged lengths put them across the warpgroup route's tiles."""
    _require_card()
    g = torch.Generator(device="cuda").manual_seed(60 + d)
    tdt = getattr(torch, dtype)
    q, do = (torch.randn(2, 3, 150, d, device="cuda", generator=g).to(tdt)
             for _ in range(2))
    k, v = (torch.randn(2, 3, 170, d, device="cuda", generator=g).to(tdt)
            for _ in range(2))
    o, lse = _launch(q, k, v, d ** -0.5, True, -30, "bhld")
    got = _launch_bwd(q, k, v, o, lse, do, d ** -0.5, True, -30, "bhld")
    torch.cuda.synchronize()
    want = _bwd_reference(q, k, v, o, lse, do, d ** -0.5, True, -30, "bhld")
    assert torch.count_nonzero(got[0][:, :, :30]) == 0
    for x, y in zip(got, want):
        _close_to_max(x, y, BWD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_dropout_masks_bit_identical_on_card(d, dtype):
    """Both dropout sites of the backward hold the forward's mask, bit
    for bit. With lq = lk = d, dO = I makes dV = (dropped P)^T, so dV's
    zeros are the mask (the dK/dV kernel's P^T); with q = k = v = I, o = 0
    (delta = 0) and dO all ones, dS = P * (dropped dP) * scale, so dQ's
    zeros (the dQ kernel) and dK's (the dK/dV kernel's dP^T) are the
    mask. P > 0 everywhere (small scores, no causal mask), so no kept
    element is 0."""
    _require_card()
    b, h, seed = 2, 4, 1234 + d
    g = torch.Generator(device="cuda").manual_seed(d)
    tdt = getattr(torch, dtype)
    eye = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous().to(tdt)
    keep = attn_keep_mask(b, h, d, d, seed, dropout_thresh(0.1), "cuda")
    kw = dict(dropout=0.1, seed=seed)
    q, k = ((0.1 * torch.randn(b, h, d, d, device="cuda", generator=g))
            .to(tdt) for _ in range(2))
    o, lse = flash_attention_fwd(q, k, eye, **kw)
    for dv in (flash_attention_bwd(q, k, eye, o, lse, eye, **kw)[2],
               flash_attention_bwd_reference(q, k, eye, o, lse, eye,
                                             **kw)[2]):
        assert torch.equal(dv != 0, keep.transpose(-1, -2))
    _, lse = flash_attention_fwd(eye, eye, eye, **kw)
    zero, ones = torch.zeros_like(eye), torch.ones_like(eye)
    for dq, dk, _ in (flash_attention_bwd(eye, eye, eye, zero, lse, ones,
                                          **kw),
                      flash_attention_bwd_reference(eye, eye, eye, zero, lse,
                                                    ones, **kw)):
        assert torch.equal(dq != 0, keep)
        assert torch.equal(dk != 0, keep.transpose(-1, -2))
    assert 0.08 < float((~keep).float().mean()) < 0.12


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
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import RMSNorm

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(9)
    x = (1.5 * torch.randn(4, 64, 2048, generator=g)).to(dt)
    grads = []
    before = (fused_rms_norm.launches, fused_rms_norm_bwd.launches)
    for dev in ("cuda", "cpu"):
        norm = RMSNorm(2048, eps=1e-5)
        norm.cast(dt)
        norm.initialize(ctx=mx.gpu(0) if dev == "cuda" else mx.cpu())
        w = norm.weight.tensor
        with torch.no_grad():
            w.copy_((1 + 0.1 * torch.randn(2048, generator=g)))
        xi = x.to(dev).requires_grad_()
        norm(xi).float().sum().backward()
        assert w.grad is not None and xi.grad is not None
        grads.append((xi.grad.cpu(), w.grad.cpu()))
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


@pytest.mark.cuda
@pytest.mark.parametrize("gdt,mp", [("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("mode", ["recip", "div", "none"])
@pytest.mark.parametrize("bounds", [None, (0.05, 5.0)])
def test_lamb_sweep_kernel_on_card(gdt, mp, mode, bounds):
    """The LAMB sweep's three kernels against the plain version over
    members of ragged sizes (below one 4096-element chunk, an empty one,
    exactly one chunk, one past it, a channels-last 3x3 convolution
    weight, BERT's word embedding table, one whose grad holds a NaN past
    its first chunk, one holding an inf, one whose weights are all zero),
    per-member lr and wd, a grad rescale of 0.5, in each bias-correction
    mode (the Trainer's f32 reciprocals, TrainStep's divisors, none),
    with and without both bounds. Phase 1 (the moments and upd) and
    phase 2 (the weights and the bf16 weights, given the kernel's own
    norms) are bit-identical to the plain version, compared as bits so
    NaNs count; r1 and r2 are within 1e-5 relative of an f64 sum over
    the same values (the kernel sums f32 partials of 4096 elements in
    f64; the zero member's r1 is exactly 0, the NaN and inf members' r2
    NaN), and a second run from the same state gives the same bits; one
    launch of each kernel per call."""
    _require_card()
    shapes = [(5,), (0,), (4096,), (4097,), (256, 128, 3, 3),
              (30522, 768), (9000,), (768,), (300,)]
    nan_j, inf_j, zero_j = 6, 7, 8
    dt = {n: getattr(torch, n) for n in ("float32", "bfloat16")}

    def members():
        g = torch.Generator(device="cuda").manual_seed(7)

        def rand(shape, dtype, scale=1.0):
            fmt = torch.channels_last if len(shape) == 4 else \
                torch.contiguous_format
            out = torch.empty(shape, device="cuda", memory_format=fmt)
            return (scale * out.normal_(generator=g)).to(dtype)

        ws = [rand(s, torch.float32, 0.05) for s in shapes]
        ws[zero_j].zero_()
        gs = [rand(s, dt[gdt], 1e-2) for s in shapes]
        gs[nan_j].view(-1)[8000] = float("nan")
        gs[inf_j].view(-1)[17] = float("inf")
        ms = [rand(s, torch.float32, 1e-3) for s in shapes]
        vs = [rand(s, torch.float32, 1e-3).square() for s in shapes]
        lows = [w.to(torch.bfloat16) for w in ws] if mp else None
        return ws, gs, ms, vs, lows

    n = len(shapes)
    lrs = [1e-3 * (1 + j) for j in range(n)]
    wds = [0.01, 0.0, 0.01, 0.1, 0.01, 0.01, 0.0, 0.01, 0.01]
    t = 3
    bc1s, bc2s = [1.0 - 0.9 ** t] * n, [1.0 - 0.999 ** t] * n
    if mode == "recip":
        bc1s = [float(np.float32(1) / np.float32(b)) for b in bc1s]
        bc2s = [float(np.float32(1) / np.float32(b)) for b in bc2s]
    lo, hi = bounds or (None, None)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=0.5,
              bias_correction=mode != "none", bc_recip=mode == "recip",
              lower_bound=lo, upper_bound=hi)
    a, b, c = members(), members(), members()
    w0 = [w.double() for w in a[0]]
    before = (fused_lamb_sweep.phase1_launches,
              fused_lamb_sweep.norms_launches, fused_lamb_sweep.launches)
    upd_k, norms_k = fused_lamb_sweep(*a, lrs, wds, bc1s, bc2s, **kw)
    upd_p, _ = lamb_sweep_reference(*b, lrs, wds, bc1s, bc2s,
                                    norms=norms_k, **kw)
    _, norms_c = fused_lamb_sweep(*c, lrs, wds, bc1s, bc2s, **kw)
    torch.cuda.synchronize()
    assert (fused_lamb_sweep.phase1_launches,
            fused_lamb_sweep.norms_launches, fused_lamb_sweep.launches) \
        == tuple(x + 2 for x in before)
    for grp in (0, 2, 3, 4):
        if a[grp] is None:
            continue
        for x, y, z in zip(a[grp], b[grp], c[grp]):
            assert x.stride() == y.stride()
            assert torch.equal(_bits(x), _bits(y))
            assert torch.equal(_bits(x), _bits(z))
    for x, y in zip(upd_k, upd_p):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))
    assert torch.equal(_bits(norms_k), _bits(norms_c))
    want = torch.stack([torch.stack([w.square().sum().sqrt(),
                                     u.double().square().sum().sqrt()])
                        for w, u in zip(w0, upd_p)]).float()
    assert torch.equal(torch.isnan(norms_k), torch.isnan(want))
    assert torch.isnan(norms_k[[nan_j, inf_j], 1]).all()
    assert float(norms_k[zero_j, 0]) == 0.0
    ok = ~torch.isnan(want)
    rel = ((norms_k - want).abs() / want.clamp_min(1e-30))[ok]
    assert float(rel.max()) <= 1e-5, float(rel.max())


@pytest.mark.cuda
def test_trainer_lamb_on_card_matches_cpu():
    """Three steps of the eager path (``autograd.record``,
    ``autograd.backward``, ``gluon.Trainer`` with LAMB) on a 2-layer f32
    ``BERTForPretrainFused`` at dropout 0 on the card against the same
    weights and batch on the CPU: the backward goes through the backward
    kernels (a graph walk that stops early prunes them: none launches)
    and one launch of each LAMB kernel per step; losses to 1e-5
    relative, each parameter's delta within 1e-3 of its norm on the CPU
    (an element whose gradient is f32 noise steps by either sign)."""
    _require_card()
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    net = BERTForPretrainFused(vocab_size=512, max_length=128, num_layers=2,
                               units=64, hidden_size=128, num_heads=4,
                               dropout=0.0, chunk=128, ctx=mx.cpu(),
                               generator=torch.Generator().manual_seed(4))
    nets = {"cpu": net, "cuda": copy.deepcopy(net).cuda()}
    w0 = [p.detach().clone() for p in net.parameters()]
    rs = np.random.RandomState(4)
    tok = torch.from_numpy(rs.randint(0, 512, (4, 128)).astype(np.int32))
    lab = torch.from_numpy(rs.randint(0, 512, (4, 128)).astype(np.int32))
    losses = {}
    for dev, n in nets.items():
        tr = mx.gluon.Trainer(n.collect_params(), "lamb",
                              {"learning_rate": 1e-3, "wd": 0.01})
        before = (fused_layer_norm_bwd.launches, fused_lamb_sweep.launches,
                  fused_lamb_sweep.phase1_launches,
                  fused_lamb_sweep.norms_launches)
        losses[dev] = []
        for _ in range(3):
            with mx.autograd.record():
                loss = n(tok.to(dev), lab.to(dev))
            mx.autograd.backward(loss)
            tr.step(loss.numel())
            losses[dev].append(float(loss.detach().mean()))
        after = (fused_layer_norm_bwd.launches, fused_lamb_sweep.launches,
                 fused_lamb_sweep.phase1_launches,
                 fused_lamb_sweep.norms_launches)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert after[0] - before[0] == 3 * 6
            assert [a - b for a, b in zip(after[1:], before[1:])] == [3] * 3
    # the readings, shown with ``-s``: the loss gap and each parameter's
    # delta gap over its norm, worst first
    gaps = []
    for (name, a), b, s in zip(nets["cuda"].named_parameters(),
                               nets["cpu"].parameters(), w0):
        da, db = a.detach().cpu() - s, b.detach() - s
        gaps.append((float((da - db).norm()) / max(float(db.norm()), 1e-30),
                     name))
    print(f"lamb card vs cpu: loss max rel "
          f"{max(abs(x / y - 1) for x, y in zip(losses['cuda'], losses['cpu']))}"
          f", delta gap / norm {sorted(gaps, reverse=True)[:3]}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for a, b, s in zip(nets["cuda"].parameters(), nets["cpu"].parameters(),
                       w0):
        da, db = a.detach().cpu() - s, b.detach() - s
        assert float((da - db).norm()) <= 1e-3 * float(db.norm())


# ---------------------------------------------------------------------------
# The norm backward's persistent ring kernel (LayerNorm +- residual +-
# dropout, RMSNorm) and the RMSNorm forward at few and many rows
# ---------------------------------------------------------------------------

_NORM_MODES = ("ln", "ln_res", "ln_res_drop", "rms")


def _norm_bwd_case(mode, rows, d, xdt, gdt):
    """(call, its plain version's outputs, output names, the wrapper, the
    keep mask or None) for one backward of ``mode`` on seeded inputs."""
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    g = torch.Generator(device="cuda").manual_seed(rows * 131 + d)
    xt, gt = getattr(torch, xdt), getattr(torch, gdt)
    gamma = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    if mode == "rms":
        x = (1.5 * torch.randn(rows, d, device="cuda", generator=g)).to(xt)
        _, rstd = _rms_norm_fwd(x, gamma, 1e-5, True)
        dy = torch.randn(rows, d, device="cuda", generator=g).to(
            torch.promote_types(xt, gt))
        return (lambda: fused_rms_norm_bwd(x, gamma, rstd, dy),
                fused_rms_norm_bwd_reference(x, gamma, rstd, dy),
                ("dx", "dw"), fused_rms_norm_bwd, None)
    x = (2 + torch.randn(rows, d, device="cuda", generator=g)).to(xt)
    r = (torch.randn(rows, d, device="cuda", generator=g).to(xt)
         if "res" in mode else None)
    beta = (0.1 * torch.randn(d, device="cuda", generator=g)).to(gt)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(xt)
    p, seed = (0.1, 4321 + rows) if mode.endswith("drop") else (0.0, None)
    _, mean, rstd = fused_layer_norm(x, gamma, beta, r, dropout=p, seed=seed,
                                     return_stats=True)
    keep = (row_keep_mask(rows, d, seed, dropout_thresh(p), "cuda")
            if p > 0 else None)
    return (lambda: fused_layer_norm_bwd(x, gamma, mean, rstd, dy, r, p,
                                         seed),
            fused_layer_norm_bwd_reference(x, gamma, mean, rstd, dy, r, p,
                                           seed),
            ("dx", "dgamma", "dbeta", "dres"), fused_layer_norm_bwd, keep)


def _check_norm_bwd(mode, rows, d, xdt, gdt):
    call, want, names, wrapper, keep = _norm_bwd_case(mode, rows, d, xdt,
                                                      gdt)
    before = wrapper.launches
    got = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert len(got) == len(want)
    # dx (dres): one rounding of f32 sums taken in another order; the
    # parameter gradients: f32 column sums in another order, rounded once
    tol = 1e-5 if xdt == "float32" and gdt == "float32" else 2.0 ** -7
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype, name
        _close_to_max(a, b, tol, name)
    n_param = 1 if mode == "rms" else 2
    again = call()
    for a, b in zip(got[1:1 + n_param], again[1:1 + n_param]):
        assert torch.equal(a, b)           # the same bits twice
    assert kernels_per_call(call) == 1
    if keep is not None:
        assert torch.equal(got[0] != 0, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 768, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 7, 131, 1056, 16384])
@pytest.mark.parametrize("mode", _NORM_MODES)
def test_norm_bwd_kernel_shapes_on_card(mode, rows, d):
    """The backward at every row count and width of the ring route's
    plans (one warp per row up to d 1024, 2-8 warps above; fewer rows
    than row groups, one row per CTA, many per CTA), bf16: within the
    tolerance of the plain version, dgamma/dbeta the same bits on two
    calls, exactly one kernel per call, dx's zeros the dropout mask."""
    _require_card()
    _check_norm_bwd(mode, rows, d, "bfloat16", "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(131, 768), (7, 2048), (1056, 4096),
                                    (5, 100), (3, 3000)])
@pytest.mark.parametrize("xdt,gdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16")])
@pytest.mark.parametrize("mode", _NORM_MODES)
def test_norm_bwd_kernel_dtypes_on_card(mode, rows, d, xdt, gdt):
    """Every dtype pair through the ring route and, at d % 8 != 0, the
    scalar route, which ends in the same in-kernel final sum."""
    _require_card()
    _check_norm_bwd(mode, rows, d, xdt, gdt)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [
    (1, 4096), (1, 8192), (1, 4104), (8, 4096), (8, 8192), (8, 4104),
    (16, 4096), (16, 8192), (16, 4104), (300, 4096), (4096, 2048),
    (40, 256)])
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_rms_fwd_kernel_on_card(rows, d, xdt, wdt):
    """The RMSNorm forward, one CTA per row with w loaded beside x, at
    decode's few rows (d 4104: 513 chunks, one thread with a chunk more)
    and at many rows, against the plain version, rstd included; the
    serving call (no rstd) gives the same bits, in one kernel."""
    _require_card()
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    g = torch.Generator(device="cuda").manual_seed(rows * 7 + d)
    x = torch.randn(rows, d, device="cuda", generator=g).to(
        getattr(torch, xdt))
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=g)).to(
        getattr(torch, wdt))
    before = fused_rms_norm.launches
    out, rstd = _rms_norm_fwd(x, w, 1e-5, True)
    torch.cuda.synchronize()
    assert fused_rms_norm.launches == before + 1
    ref, ref_rstd = fused_rms_norm_reference(x, w, eps=1e-5,
                                             return_rstd=True)
    assert out.dtype == ref.dtype
    rtol = (1e-5 if xdt == "float32" else
            BF16_OUT_RTOL if wdt == "bfloat16" else BF16_RTOL)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=1e-5)
    torch.testing.assert_close(rstd, ref_rstd, rtol=1e-5, atol=0.0)
    assert torch.equal(fused_rms_norm(x, w, eps=1e-5), out)
    assert kernels_per_call(lambda: fused_rms_norm(x, w, eps=1e-5)) == 1
