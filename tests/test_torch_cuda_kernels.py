"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at the Llama-3-8B serving path's shapes.

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

from mxnet_tpu_torch.kernels import (fused_rms_norm, fused_rms_norm_reference,
                                     paged_attention_kernel,
                                     paged_attention_reference)

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
