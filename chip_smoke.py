#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) end to end on one card.

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file; exits non-zero
without a result line otherwise. It imports nothing of JAX or of the JAX
package. Phases, each printing JSON lines and failing loudly:

1. device  — the card's name and power limit, as nvidia-smi gives them;
2. build   — nvcc builds every kernel from the checkout's sources, one
             process per source, all at once (into build/kernels/,
             listed in .gitignore);
3. kernels — each kernel against its plain PyTorch version at its
             path's shapes, bf16 and f32, with its stated tolerance (the
             backward kernels on BERT-base's (32 x 512) batch, flash on
             its fused-QKV views and a causal (2, 8, 2048, 128); the
             RMSNorm forward with its rstd and backward at the proxy1b
             step's (8 x 2048, 2048), causal flash at its (8, 16, 2048,
             128); the Adam sweep over BERTForPretrainFused's bf16
             multi-precision parameter set and the AdamW scan and sweep
             over proxy1b's and the SGD sweep over ResNet-50's two
             buckets, bit for bit; the dropout modes at p = 0.1:
             the hash-dropout kernel bit for bit, LayerNorm ± residual
             forward and backward with dx's zeros equal to the mask,
             flash forward and backward, and flash's mask bit for bit
             through lk = d with V the identity); kernel, plain and
             library-call times from CUDA events (cold L2), and the
             least time the card could take (bound_ms) from this run's
             bytes and operations;
4. reference — the Llama decode path at Llama-3-8B widths, depth cut to
             2 layers, in f32: each stream's last decode-step logits
             against forward_full over the same tokens, to f32 noise;
5. serving — Llama-3-8B at full width (32 layers, bf16, seeded random
             weights) behind serving.Server: 8 concurrent
             submit_generate calls (prompts of 100-500 tokens, 32 new
             tokens each); tokens/s, TTFT, per-token latency, the
             kernels' launch counts over this phase, and each stream's
             last decode-step logits against forward_full over the same
             tokens;
6. bert_reference — BERT-base widths, depth cut to 2 layers, every
             output (masked-LM head included), in f32: each sample served
             through Server.submit against a batch-1 forward of the same
             padded sample, and that forward against the same weights
             run through the plain versions (a CPU copy of the model),
             both to f32 noise;
7. bert_serving — bert_12_768_12 at full width and depth (bf16, seeded
             random weights, no MLM head) behind Server.submit: 256
             requests of 16-512 tokens from 8 client threads; requests/s,
             real and padded tokens/s, p50/p99 latency, batches by close
             reason, occupancy, the launches of each kernel per dispatched
             forward (exactly 25 LayerNorm, 12 flash, 12 bias+GELU), each
             response against its batch-1 forward, a breakdown of one
             (32, 512) forward (host vs device ms, top device events),
             and the burst served again under the profiler (the card's
             busy share of the wall time, its top device events);
8. train_reference — BERTForPretrainFused at BERT-base widths, depth
             cut to 2 layers, f32: three TrainStep Adam steps on the card
             against the same weights, batch and step seeds on the CPU
             (the plain versions): each loss, and each parameter's delta
             over the run by norm ratio; at dropout 0, then at 0.1 / 0.1;
9. bert_train — BERTForPretrainFused at bert_12_768_12, not cut (bf16,
             multi-precision Adam at lr 1e-4, seeded random weights), one
             (32, 512) batch, at dropout 0 and BERT's published 0.1 /
             0.1 in turns (0, 0.1, 0.1, 0) in the same process: 3
             warm-up and 20 timed TrainStep calls each; ms per step,
             samples/s, MFU, peak memory, the loss (finite, falling),
             exactly 26/26 LayerNorm (12 with dropout), 13/13
             bias+GELU, 12/12 flash (dropping with attention dropout)
             and 25/25 hash-dropout launches forward/backward and one
             sweep per dtype bucket per step, and a profiled step (host
             vs device ms, idle share, top device events, each port
             kernel's device time per launch);
10. llama_train_reference — LlamaModel(fused_ce=True) at proxy1b
             widths, depth cut to 2 layers, f32: three TrainStep AdamW
             steps on the card against the same weights and batch on the
             CPU (each loss to 1e-5, each parameter's delta by norm ratio
             to 1e-3) and the launch counts;
11. llama_train — the proxy1b Llama (700.5M parameters) not cut, built
             by mxnet_tpu_torch.tools.pretrain_llama (bf16, fused CE
             head, multi-precision AdamW at lr 3e-4, wd 0.1, beta 0.9 /
             0.95, seeded random weights), one (8, 2048) batch of
             RandomState(0) tokens: 3 warm-up and 10 timed TrainStep
             calls; ms per step, tokens/s, MFU, peak memory, the loss
             (finite, falling), exactly 21/21 RMSNorm and 10/10 flash
             launches forward/backward, one AdamW scan and one sweep per
             step and no other training kernel, and a profiled step;
12. summary — one {"kernels": [...]} line.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
                  torch.float32: 67e12}     # f32 outside the tensor cores
SEED = 0
N_STREAMS = 8
NEW_TOKENS = 32
BERT_REQUESTS = 256
BERT_CLIENTS = 8
BF16_ULP = 2.0 ** -7        # bf16 keeps 8 significant bits


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's path needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from mxnet_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    out = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build_seconds,
          "sources": list(_build.SOURCES),
          "dir": str(out.relative_to(_build.REPO_ROOT))})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

class _L2Flush:
    """Reads a buffer 2.5 times the 50 MB L2 before each timed launch, so
    every timing starts cold, as the serving path finds its inputs after
    a layer's weights have streamed through. A read leaves clean lines: a
    write-based flush would leave the timed kernel paying for dirty-line
    write-backs."""

    def __init__(self):
        self.buf = torch.ones(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self):
        self.buf.sum()


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each bracketed
    by CUDA events after an L2 flush."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(least time in ms, what bounds it): bytes over the memory rate vs
    operations over the peak rate for the dtype."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def within(out, ref, rtol, atol) -> tuple:
    """(max |out - ref|, whether every element meets atol + rtol*|ref|)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.all(err <= atol + rtol * ref.abs()))
    return float(err.max()), ok


# tolerances (see tests/test_torch_cuda_kernels.py): f32 differs in the
# order of f32 sums only; bf16 RMS output rounds twice (xhat, then the
# weight product) so two bf16 ulps; paged bf16 output rounds once
RMS_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -6, 1e-5)}
PAGED_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
# LayerNorm and bias+GELU: the same f32 arithmetic (statistics summed in
# another order, erff vs torch.erf), rounded once to bf16: one ulp;
# flash: bf16 P rounds against the running row max in the kernel and the
# final one in the plain version, then the output rounds once more; the
# f32 lse differs in the order of f32 sums
LN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
GELU_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -7, 1e-6)}
FLASH_TOL = {torch.float32: (2e-5, 2e-5),
             torch.bfloat16: (2.0 ** -6, 2.0 ** -7)}
LSE_TOL = (1e-5, 1e-4)


def _size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def rms_case(rows, d, dtype, flush, gen, rstd=False) -> dict:
    """The RMSNorm forward; with ``rstd`` the training path's call, which
    also writes the f32 row rstd (held against the plain version's to
    1e-5 relative; the output must equal the serving call's bit for
    bit)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_rms_norm,
                                         fused_rms_norm_reference)
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    x = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    out = fused_rms_norm(x, w, eps=eps)
    torch.cuda.synchronize()
    ref, ref_rstd = fused_rms_norm_reference(x, w, eps=eps,
                                             return_rstd=True)
    err, ok = within(out, ref, *RMS_TOL[dtype])
    rec = {"phase": "kernels", "kernel": "fused_rms_norm",
           "shape": [rows, d], "dtype": str(dtype).split(".")[-1],
           "rstd": rstd}
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = rows * d * size * 2 + d * size
    if rstd:
        out2, got_rstd = _rms_norm_fwd(x, w, eps, True)
        torch.cuda.synchronize()
        rstd_err, rstd_ok = within(got_rstd, ref_rstd, 1e-5, 0.0)
        ok = ok and rstd_ok and torch.equal(out2, out)
        rec["rstd_max_abs_err"] = rstd_err
        n_bytes += 4 * rows
        kern = lambda: _rms_norm_fwd(x, w, eps, True)      # noqa: E731
    else:
        kern = lambda: fused_rms_norm(x, w, eps=eps)        # noqa: E731
    b_ms, b_by = bound(n_bytes, 4.0 * rows * d, torch.float32)
    rec.update({
        "max_abs_err": err, "rtol_atol": list(RMS_TOL[dtype]), "ok": ok,
        "ms": time_ms(kern, flush),
        "plain_ms": time_ms(lambda: fused_rms_norm_reference(
            x, w, eps=eps, return_rstd=rstd), flush),
        "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, eps), flush),
        "bound_ms": b_ms, "bound_by": b_by})
    emit(rec)
    return rec


def rms_bwd_case(rows, d, dtype, flush, gen) -> dict:
    """The RMSNorm backward from the forward's saved rstd, dx and dw
    against the plain version (BWD_TOL of each one's largest magnitude).
    Library yardstick: F.rms_norm forward and its autograd backward on
    the same inputs (timed only; no single call gives the backward
    alone). Bytes: x and dy read, dx written, the rstd and the weight
    once; ~10 f32 operations per element (xhat, wdy, two products and a
    sum for the row mean, the dx expression, the dw sum)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_rms_norm_bwd,
                                         fused_rms_norm_bwd_reference)
    from mxnet_tpu_torch.kernels.fused_layers import _rms_norm_fwd

    x = (1.5 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    _, rstd = _rms_norm_fwd(x, w, 1e-5, True)
    got = fused_rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    err, rel = max_rel(got, fused_rms_norm_bwd_reference(x, w, rstd, dy))
    leaves = [t.detach().requires_grad_() for t in (x, w)]

    def library():
        y = F.rms_norm(leaves[0], (d,), leaves[1], 1e-5)
        torch.autograd.grad(y, leaves, dy)

    size = _size(dtype)
    n_bytes = 3 * rows * d * size + 4 * rows + 2 * d * size
    b_ms, b_by = bound(n_bytes, 10.0 * rows * d, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_rms_norm_bwd",
           "shape": [rows, d], "dtype": _dname(dtype), "max_abs_err": err,
           "max_err_over_max_ref": rel, "tol": BWD_TOL[dtype],
           "ok": rel <= BWD_TOL[dtype],
           "ms": time_ms(lambda: fused_rms_norm_bwd(x, w, rstd, dy), flush),
           "plain_ms": time_ms(lambda: fused_rms_norm_bwd_reference(
               x, w, rstd, dy), flush),
           "library_ms": time_ms(library, flush),
           "library": "F.rms_norm forward + its autograd backward",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def paged_case(b, dtype, flush, rs, gen) -> dict:
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (paged_attention_kernel,
                                         paged_attention_reference)

    h, kv, d, ps, max_len = 32, 8, 128, 16, 1024
    lengths = rs.randint(1, max_len + 1, size=b).astype(np.int32)
    if b > 1:
        lengths[-1] = 0                 # one empty (padding) row
    width = max_len // ps
    # scattered pages: a random permutation of the arena's pages
    table = rs.permutation(np.arange(1, 1 + b * width)).astype(
        np.int32).reshape(b, width)
    n_slots = (1 + b * width) * ps
    q = torch.randn(b, h, 1, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(n_slots, kv, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(n_slots, kv, d, device="cuda", generator=gen).to(dtype)
    pt = torch.from_numpy(table).cuda()
    ln = torch.from_numpy(lengths).cuda()
    scale = 1.0 / np.sqrt(d)

    def kern():
        return paged_attention_kernel(q, k, v, pt, ln, page_size=ps,
                                      scale=scale)

    def plain():
        return paged_attention_reference(q, k, v, pt, ln, page_size=ps,
                                         scale=scale)

    out = kern()
    torch.cuda.synchronize()
    err, ok = within(out, plain(), *PAGED_TOL[dtype])
    if b > 1:                                            # empty row -> 0
        ok = ok and int(torch.count_nonzero(out[-1])) == 0
    # library yardstick: SDPA over K/V gathered beforehand (the gather is
    # not timed) with a length mask and grouped-query heads
    slots = (pt.long()[:, :, None] * ps
             + torch.arange(ps, device="cuda")).reshape(b, -1)
    kg = k[slots].transpose(1, 2).contiguous()          # (B, KV, T, D)
    vg = v[slots].transpose(1, 2).contiguous()
    mask = (torch.arange(slots.shape[1], device="cuda")[None, :]
            < ln.long()[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask,
                                              enable_gqa=True)

    size = torch.tensor([], dtype=dtype).element_size()
    tot = int(lengths.sum())
    n_pages_read = int(sum(-(-int(n) // ps) for n in lengths))
    n_bytes = (2 * tot * kv * d * size + 2 * b * h * d * size
               + 4 * (n_pages_read + b))
    b_ms, b_by = bound(n_bytes, 4.0 * tot * h * d, dtype)
    rec = {"phase": "kernels", "kernel": "paged_attention_kernel",
           "shape": {"B": b, "H": h, "KV": kv, "D": d, "page_size": ps,
                     "sum_len": tot},
           "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
           "rtol_atol": list(PAGED_TOL[dtype]), "ok": ok,
           "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(library, flush),
           "bound_ms": b_ms, "bound_by": b_by, "ctas": b * kv}
    emit(rec)
    return rec


def ln_case(rows, d, dtype, with_res, flush, gen) -> dict:
    """LayerNorm(x + residual) over (rows, d), gamma/beta in x's dtype.
    Library yardstick: F.layer_norm without the residual (no single
    PyTorch call adds a residual, so that case records null)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_reference)

    x = (2 + torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    r = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
         if with_res else None)
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    out = fused_layer_norm(x, g, b, r, eps=eps)
    torch.cuda.synchronize()
    err, ok = within(out, fused_layer_norm_reference(x, g, b, r, eps=eps),
                     *LN_TOL[dtype])
    size = _size(dtype)
    n_bytes = rows * d * size * (3 if with_res else 2) + 2 * d * size
    # sum (+ residual add), centre, square-accumulate, normalise, scale,
    # shift: ~7 f32 operations per element
    b_ms, b_by = bound(n_bytes, 7.0 * rows * d, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_layer_norm",
           "shape": [rows, d], "residual": with_res, "dtype": _dname(dtype),
           "max_abs_err": err, "rtol_atol": list(LN_TOL[dtype]), "ok": ok,
           "ms": time_ms(lambda: fused_layer_norm(x, g, b, r, eps=eps),
                         flush),
           "plain_ms": time_ms(lambda: fused_layer_norm_reference(
               x, g, b, r, eps=eps), flush),
           "library_ms": None if with_res else time_ms(
               lambda: F.layer_norm(x, (d,), g, b, eps), flush),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def gelu_case(rows, d, dtype, flush, gen) -> dict:
    """gelu(x + b) over (rows, d). No single PyTorch call computes this
    function (F.gelu takes no bias), so library_ms is null."""
    from mxnet_tpu_torch.kernels import (fused_bias_gelu,
                                         fused_bias_gelu_reference)

    x = (2 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    bias = torch.randn(d, device="cuda", generator=gen).to(dtype)
    out = fused_bias_gelu(x, bias)
    torch.cuda.synchronize()
    err, ok = within(out, fused_bias_gelu_reference(x, bias),
                     *GELU_TOL[dtype])
    size = _size(dtype)
    # add, scale, erf (counted as one), add, two multiplies
    b_ms, b_by = bound(2 * rows * d * size + d * size, 6.0 * rows * d,
                       torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_bias_gelu",
           "shape": [rows, d], "dtype": _dname(dtype), "max_abs_err": err,
           "rtol_atol": list(GELU_TOL[dtype]), "ok": ok,
           "ms": time_ms(lambda: fused_bias_gelu(x, bias), flush),
           "plain_ms": time_ms(lambda: fused_bias_gelu_reference(x, bias),
                               flush),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _flash_inputs(b, h, l, d, layout, dtype, gen, n, views):
    """``n`` tensors in ``layout``: "blhd" with ``views`` as
    MultiHeadAttention makes q, k and v, (b, l, h, d) views into one
    (b, l, 3*h*d) fused QKV output (sequence stride 3*h*d, k and v h*d
    and 2*h*d elements in), and any further ones contiguous; "blhd"
    without ``views`` contiguous (b, l, h, d) tensors, as the Llama path
    hands them over (rope's outputs and the repeated KV heads); "bhld"
    contiguous (b, h, l, d) tensors."""
    if layout == "blhd" and views:
        qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                          generator=gen).to(dtype)
        out = [t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1)]
        return out + [torch.randn(b, l, h, d, device="cuda",
                                  generator=gen).to(dtype)
                      for _ in range(n - 3)]
    shape = (b, l, h, d) if layout == "blhd" else (b, h, l, d)
    return [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            for _ in range(n)]


def flash_case(b, h, l, d, causal, layout, dtype, flush, gen,
               views=True) -> dict:
    """Flash attention forward, output and lse against the plain version
    on the same inputs (``_flash_inputs``: "blhd" on fused-QKV views, or
    contiguous with ``views`` False; "bhld" contiguous). Library
    yardstick: F.scaled_dot_product_attention on the same inputs (timed
    only; the port never calls it). Operations count the key positions
    this run visits: all l for every row, or the causal triangle."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (flash_attention_fwd,
                                         flash_attention_reference)

    q, k, v = _flash_inputs(b, h, l, d, layout, dtype, gen, 3, views)
    sdpa_in = [t.transpose(1, 2) for t in (q, k, v)] \
        if layout == "blhd" else [q, k, v]
    kw = {"causal": causal, "layout": layout}
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, rlse = flash_attention_reference(q, k, v, **kw)
    err, ok = within(out, ref, *FLASH_TOL[dtype])
    lse_err, lse_ok = within(lse, rlse, *LSE_TOL)
    pairs = l * (l + 1) // 2 if causal else l * l
    n_ops = 4.0 * b * h * pairs * d
    n_bytes = 4 * b * h * l * d * _size(dtype) + 4 * b * h * l
    b_ms, b_by = bound(n_bytes, n_ops, dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention",
           "shape": [b, h, l, d], "layout": layout, "views": views,
           "q_strides": list(q.stride()), "causal": causal,
           "dtype": _dname(dtype), "max_abs_err": err,
           "lse_max_abs_err": lse_err, "rtol_atol": list(FLASH_TOL[dtype]),
           "lse_rtol_atol": list(LSE_TOL), "ok": ok and lse_ok,
           "ms": time_ms(lambda: flash_attention_fwd(q, k, v, **kw), flush),
           "plain_ms": time_ms(lambda: flash_attention_reference(
               q, k, v, **kw), flush),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               *sdpa_in, is_causal=causal), flush),
           "bound_ms": b_ms, "bound_by": b_by, "gflop": n_ops / 1e9,
           "mbytes": n_bytes / 1e6}
    emit(rec)
    return rec


# backward kernels: max |kernel - plain| over max |plain| (the gradients
# sum over many rows, so an elementwise test near 0 says nothing). f32:
# sums in other orders; bf16: P and dS (flash), or dx, dgamma and dbeta
# (LayerNorm, bias+GELU), round once from f32 values summed in another
# order, and each gradient rounds once more: two bf16 ulps of the
# largest magnitude
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def max_rel(outs, refs) -> tuple:
    """(largest max |out - ref|, whether each out is finite and within
    its BWD tolerance of max |ref|) over pairs, as f32."""
    errs, rels = [], []
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        errs.append(float((o - r).abs().max()))
        rels.append(errs[-1] / max(float(r.abs().max()), 1e-30)
                    if bool(torch.isfinite(o).all()) else float("inf"))
    return max(errs), max(rels)


def _grad_timer(out, inputs, grad):
    """A callable running autograd's backward of ``out`` with respect to
    ``inputs`` for ``grad`` (the graph is kept, so it can run again)."""
    return lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True)


def flash_bwd_case(b, h, l, d, causal, layout, dtype, flush, gen,
                   views=True) -> dict:
    """Flash attention backward (dq, dk, dv) against its plain version on
    the forward's own output and lse, on flash_case's inputs. Library
    yardstick: the autograd backward of F.scaled_dot_product_attention on
    the same inputs (timed only). Operations: the five products of the
    causal triangle or the full square; bytes: q, k, v, o, dO and lse
    read, dq, dk, dv written."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (flash_attention_bwd,
                                         flash_attention_bwd_reference,
                                         flash_attention_fwd)

    q, k, v, do = _flash_inputs(b, h, l, d, layout, dtype, gen, 4, views)
    if layout == "blhd":
        to_sdpa = lambda t: t.transpose(1, 2)           # noqa: E731
    else:
        to_sdpa = lambda t: t                           # noqa: E731
    kw = {"causal": causal, "layout": layout}
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    err, rel = max_rel(got, flash_attention_bwd_reference(q, k, v, o, lse,
                                                          do, **kw))
    leaves = [to_sdpa(t).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    pairs = l * (l + 1) // 2 if causal else l * l
    n_ops = 5 * 2.0 * b * h * pairs * d
    n_bytes = 8 * b * h * l * d * _size(dtype) + 4 * b * h * l
    b_ms, b_by = bound(n_bytes, n_ops, dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention_bwd",
           "shape": [b, h, l, d], "layout": layout, "views": views,
           "causal": causal,
           "dtype": _dname(dtype), "max_abs_err": err,
           "max_err_over_max_ref": rel, "tol": BWD_TOL[dtype],
           "ok": rel <= BWD_TOL[dtype],
           "ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                     **kw), flush),
           "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
               q, k, v, o, lse, do, **kw), flush),
           "library_ms": time_ms(_grad_timer(sdpa_out, leaves, to_sdpa(do)),
                                 flush),
           "library": "autograd backward of F.scaled_dot_product_attention",
           "bound_ms": b_ms, "bound_by": b_by, "gflop": n_ops / 1e9,
           "mbytes": n_bytes / 1e6}
    emit(rec)
    return rec


def ln_bwd_case(rows, d, dtype, with_res, flush, gen) -> dict:
    """LayerNorm(x + residual) backward from the forward's f32 row
    statistics. Library yardstick: autograd's backward of F.layer_norm
    without the residual (null with it: no single call adds one)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_layer_norm_bwd_reference)

    x = (2 + torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    r = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
         if with_res else None)
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    _, mean, rstd = fused_layer_norm(x, g, b, r, return_stats=True)
    got = fused_layer_norm_bwd(x, g, mean, rstd, dy, r)
    torch.cuda.synchronize()
    err, rel = max_rel(got, fused_layer_norm_bwd_reference(x, g, mean, rstd,
                                                           dy, r))
    library = None
    if not with_res:
        leaves = [t.detach().requires_grad_() for t in (x, g, b)]
        y = F.layer_norm(leaves[0], (d,), leaves[1], leaves[2], 1e-5)
        library = time_ms(_grad_timer(y, leaves, dy), flush)
    size = _size(dtype)
    n_bytes = rows * d * size * (4 if with_res else 3) + 8 * rows \
        + 3 * d * size
    # recentre, scale, two products and two sums for the row means, the
    # dh expression, two column sums: ~12 f32 operations per element
    b_ms, b_by = bound(n_bytes, 12.0 * rows * d, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_layer_norm_bwd",
           "shape": [rows, d], "residual": with_res, "dtype": _dname(dtype),
           "max_abs_err": err, "max_err_over_max_ref": rel,
           "tol": BWD_TOL[dtype], "ok": rel <= BWD_TOL[dtype],
           "ms": time_ms(lambda: fused_layer_norm_bwd(x, g, mean, rstd, dy,
                                                      r), flush),
           "plain_ms": time_ms(lambda: fused_layer_norm_bwd_reference(
               x, g, mean, rstd, dy, r), flush),
           "library_ms": library,
           "library": "null: no single PyTorch call adds a residual"
                      if with_res else "autograd backward of F.layer_norm",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def gelu_bwd_case(rows, d, dtype, flush, gen) -> dict:
    """bias+GELU backward, recomputed from (x, bias). No single PyTorch
    call computes it (F.gelu takes no bias), so library_ms is null."""
    from mxnet_tpu_torch.kernels import (fused_bias_gelu_bwd,
                                         fused_bias_gelu_bwd_reference)

    x = (2 * torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    bias = torch.randn(d, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    got = fused_bias_gelu_bwd(x, bias, dy)
    torch.cuda.synchronize()
    err, rel = max_rel(got, fused_bias_gelu_bwd_reference(x, bias, dy))
    size = _size(dtype)
    # add, erf and exp (one each), ~6 multiplies and adds, the bias sum
    b_ms, b_by = bound(3 * rows * d * size + d * size, 10.0 * rows * d,
                       torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_bias_gelu_bwd",
           "shape": [rows, d], "dtype": _dname(dtype), "max_abs_err": err,
           "max_err_over_max_ref": rel, "tol": BWD_TOL[dtype],
           "ok": rel <= BWD_TOL[dtype],
           "ms": time_ms(lambda: fused_bias_gelu_bwd(x, bias, dy), flush),
           "plain_ms": time_ms(lambda: fused_bias_gelu_bwd_reference(
               x, bias, dy), flush),
           "library_ms": None,
           "library": "null: no single PyTorch call (F.gelu takes no bias)",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the dropout modes (position-hash dropout) against their plain versions
# ---------------------------------------------------------------------------

DROP_P = 0.1
# integer operations of the murmur hash and the keep test per element;
# counted at the CUDA cores' f32 rate (the card's table has no int32 row)
HASH_OPS = 12.0


def bound_mixed(n_bytes: float, ops) -> tuple:
    """(least time in ms, what bounds it) for work on several units at
    once: ``ops`` is [(operations, dtype), ...], each over its own peak
    rate; the least time is the largest of those and the bytes' time."""
    best = (n_bytes / HBM_BYTES_PER_S * 1e3, "bytes")
    for n_ops, dtype in ops:
        t = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
        if t > best[0]:
            best = (t, "operations")
    return best


def hash_dropout_case(shape, dtype, flush, gen) -> dict:
    """The Dropout op's kernel at p = 0.1 against its plain version: bit
    for bit, so its zeros are the plain version's mask. Library
    yardstick: F.dropout (it draws its own Philox mask; the work is the
    same)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import hash_dropout, hash_dropout_reference

    x = torch.randn(*shape, device="cuda", generator=gen).to(dtype)
    seed = 0x5EED
    out = hash_dropout(x, DROP_P, seed)
    torch.cuda.synchronize()
    ref = hash_dropout_reference(x, DROP_P, seed)
    same = torch.equal(out, ref)
    mask_same = torch.equal(out == 0, ref == 0)
    n = x.numel()
    b_ms, b_by = bound_mixed(2.0 * n * _size(dtype),
                             [(HASH_OPS * n, torch.float32)])
    rec = {"phase": "kernels", "kernel": "hash_dropout", "shape": list(shape),
           "dtype": _dname(dtype), "p": DROP_P, "bit_identical": same,
           "mask_identical": mask_same,
           "drop_share": float((ref == 0).float().mean()),
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "ok": same and mask_same,
           "ms": time_ms(lambda: hash_dropout(x, DROP_P, seed), flush),
           "plain_ms": time_ms(lambda: hash_dropout_reference(x, DROP_P,
                                                              seed), flush),
           "library_ms": time_ms(lambda: F.dropout(x, DROP_P, training=True),
                                 flush),
           "library": "F.dropout (its own Philox mask)",
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def ln_drop_cases(rows, d, dtype, with_res, flush, gen) -> list:
    """LayerNorm(dropout(x) + residual) at p = 0.1, forward and backward,
    against the plain versions (LN_TOL forward; BWD_TOL backward, dres
    included); the zeros of dx must be the mask of the flat (row, col)
    ids bit for bit. No single PyTorch call drops and normalises, so
    library_ms is null."""
    from mxnet_tpu_torch.kernels import (fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_layer_norm_bwd_reference,
                                         fused_layer_norm_reference)
    from mxnet_tpu_torch.kernels.dropout import dropout_thresh, row_keep_mask

    x = (2 + torch.randn(rows, d, device="cuda", generator=gen)).to(dtype)
    r = (torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
         if with_res else None)
    g = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    b = (0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    dy = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    seed = 0xD0D0 + int(with_res)
    kw = {"dropout": DROP_P, "seed": seed}
    out, mean, rstd = fused_layer_norm(x, g, b, r, return_stats=True, **kw)
    got = fused_layer_norm_bwd(x, g, mean, rstd, dy, r, DROP_P, seed)
    torch.cuda.synchronize()
    f_err, f_ok = within(out, fused_layer_norm_reference(x, g, b, r, **kw),
                         *LN_TOL[dtype])
    want = fused_layer_norm_bwd_reference(x, g, mean, rstd, dy, r, DROP_P,
                                          seed)
    b_err, rel = max_rel(got, want)
    keep = row_keep_mask(rows, d, seed, dropout_thresh(DROP_P), "cuda")
    mask_same = bool(torch.equal(got[0] != 0, keep)
                     and torch.equal(want[0] != 0, keep))
    size = _size(dtype)
    f_ms, f_by = bound_mixed(
        rows * d * size * (3 if with_res else 2) + 2 * d * size,
        [(7.0 * rows * d, torch.float32), (HASH_OPS * rows * d,
                                            torch.float32)])
    # x, dy (and the residual) read; dx (and dres) written
    bw_ms, bw_by = bound_mixed(
        rows * d * size * (5 if with_res else 3) + 8 * rows + 3 * d * size,
        [(12.0 * rows * d, torch.float32), (HASH_OPS * rows * d,
                                             torch.float32)])
    common = {"phase": "kernels", "shape": [rows, d], "residual": with_res,
              "dtype": _dname(dtype), "p": DROP_P, "library_ms": None,
              "library": "null: no single PyTorch call drops and "
                         "normalises"}
    fwd = dict(common, kernel="fused_layer_norm[dropout]",
               max_abs_err=f_err, rtol_atol=list(LN_TOL[dtype]), ok=f_ok,
               ms=time_ms(lambda: fused_layer_norm(x, g, b, r, **kw), flush),
               plain_ms=time_ms(lambda: fused_layer_norm_reference(
                   x, g, b, r, **kw), flush),
               bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, kernel="fused_layer_norm_bwd[dropout]",
               max_abs_err=b_err, max_err_over_max_ref=rel,
               tol=BWD_TOL[dtype], mask_identical=mask_same,
               ok=rel <= BWD_TOL[dtype] and mask_same,
               ms=time_ms(lambda: fused_layer_norm_bwd(
                   x, g, mean, rstd, dy, r, DROP_P, seed), flush),
               plain_ms=time_ms(lambda: fused_layer_norm_bwd_reference(
                   x, g, mean, rstd, dy, r, DROP_P, seed), flush),
               bound_ms=bw_ms, bound_by=bw_by)
    emit(fwd)
    emit(bwd)
    return [fwd, bwd]


def flash_drop_cases(b, h, l, d, causal, layout, dtype, flush,
                     gen) -> list:
    """Flash attention forward and backward at p = 0.1 against the plain
    versions, "blhd" on BERT's fused-QKV views as flash_case builds them.
    Library yardstick: F.scaled_dot_product_attention with dropout_p=0.1
    and its autograd backward (SDPA draws its own mask; only the work is
    the same). Operations: the products as without dropout, plus one
    hash per score, forward and backward."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (flash_attention_bwd,
                                         flash_attention_bwd_reference,
                                         flash_attention_fwd,
                                         flash_attention_reference)

    if layout == "blhd":
        qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                          generator=gen).to(dtype)
        q, k, v = (t.view(b, l, h, d) for t in qkv.split(h * d, dim=-1))
        do = torch.randn(b, l, h, d, device="cuda", generator=gen).to(dtype)
        to_sdpa = lambda t: t.transpose(1, 2)           # noqa: E731
    else:
        q, k, v, do = (torch.randn(b, h, l, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        to_sdpa = lambda t: t                           # noqa: E731
    kw = {"causal": causal, "layout": layout, "dropout": DROP_P,
          "seed": 0xF1A5 + l}
    o, lse = flash_attention_fwd(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    ref, rlse = flash_attention_reference(q, k, v, **kw)
    f_err, f_ok = within(o, ref, *FLASH_TOL[dtype])
    lse_err, lse_ok = within(lse, rlse, *LSE_TOL)
    b_err, rel = max_rel(got, flash_attention_bwd_reference(q, k, v, o, lse,
                                                            do, **kw))
    leaves = [to_sdpa(t).detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              dropout_p=DROP_P)
    pairs = l * (l + 1) // 2 if causal else l * l
    scores = b * h * pairs
    size = _size(dtype)
    f_ms, f_by = bound_mixed(4 * b * h * l * d * size + 4 * b * h * l,
                             [(4.0 * scores * d, dtype),
                              (HASH_OPS * scores, torch.float32)])
    bw_ms, bw_by = bound_mixed(8 * b * h * l * d * size + 4 * b * h * l,
                               [(10.0 * scores * d, dtype),
                                (HASH_OPS * scores, torch.float32)])
    common = {"phase": "kernels", "shape": [b, h, l, d], "layout": layout,
              "causal": causal, "dtype": _dname(dtype), "p": DROP_P}
    fwd = dict(common, kernel="flash_attention[dropout]", max_abs_err=f_err,
               lse_max_abs_err=lse_err, rtol_atol=list(FLASH_TOL[dtype]),
               ok=f_ok and lse_ok,
               ms=time_ms(lambda: flash_attention_fwd(q, k, v, **kw), flush),
               plain_ms=time_ms(lambda: flash_attention_reference(
                   q, k, v, **kw), flush),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   *[to_sdpa(t) for t in (q, k, v)], is_causal=causal,
                   dropout_p=DROP_P), flush),
               library="F.scaled_dot_product_attention(dropout_p=0.1)",
               bound_ms=f_ms, bound_by=f_by)
    bwd = dict(common, kernel="flash_attention_bwd[dropout]",
               max_abs_err=b_err, max_err_over_max_ref=rel,
               tol=BWD_TOL[dtype], ok=rel <= BWD_TOL[dtype],
               ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw), flush),
               plain_ms=time_ms(lambda: flash_attention_bwd_reference(
                   q, k, v, o, lse, do, **kw), flush),
               library_ms=time_ms(_grad_timer(sdpa_out, leaves, to_sdpa(do)),
                                  flush),
               library="autograd backward of F.scaled_dot_product_attention"
                       "(dropout_p=0.1)",
               bound_ms=bw_ms, bound_by=bw_by)
    emit(fwd)
    emit(bwd)
    return [fwd, bwd]


def flash_mask_case(d, dtype, flush, gen) -> dict:
    """The flash forward's mask, bit for bit: with lk = d and V the
    identity, O is the dropped, normalised P, so its zeros are the mask;
    the kernel's zeros must be the plain version's (q and k are small,
    so no kept P underflows to 0)."""
    from mxnet_tpu_torch.kernels import (flash_attention_fwd,
                                         flash_attention_reference)

    b, h, lq = 32, 12, 512
    q = (0.1 * torch.randn(b, h, lq, d, device="cuda",
                           generator=gen)).to(dtype)
    k = (0.1 * torch.randn(b, h, d, d, device="cuda",
                           generator=gen)).to(dtype)
    v = torch.eye(d, device="cuda").expand(b, h, d, d).contiguous().to(
        dtype)
    kw = {"dropout": DROP_P, "seed": 0xA5A5 + d}
    out, _ = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ref, _ = flash_attention_reference(q, k, v, **kw)
    same = bool(torch.equal(out == 0, ref == 0))
    scores = b * h * lq * d
    b_ms, b_by = bound_mixed(
        (2 * b * h * lq * d + 2 * b * h * d * d) * _size(dtype) + 4 * b * h
        * lq, [(4.0 * scores * d, dtype), (HASH_OPS * scores,
                                            torch.float32)])
    rec = {"phase": "kernels", "kernel": "flash_attention[dropout, mask]",
           "shape": [b, h, lq, d], "lk": d, "v": "identity",
           "dtype": _dname(dtype), "p": DROP_P, "mask_identical": same,
           "drop_share": float((ref == 0).float().mean()), "ok": same,
           "ms": time_ms(lambda: flash_attention_fwd(q, k, v, **kw), flush),
           "plain_ms": time_ms(lambda: flash_attention_reference(
               q, k, v, **kw), flush), "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by}
    emit(rec)
    return rec


def _pretrain_shapes() -> list:
    """The trainable parameter shapes of BERTForPretrainFused at
    bert_12_768_12's widths (the tied projection counted once)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    net = BERTForPretrainFused(dropout=0.0, ctx="cuda",
                               dtype=torch.bfloat16)
    shapes = [tuple(p.shape) for p in net.parameters()]
    del net
    torch.cuda.empty_cache()
    return shapes


def adam_case(flush, gen) -> dict:
    """The fused Adam sweep over BERTForPretrainFused's bf16
    multi-precision parameter set (f32 masters and moments, bf16 grads,
    the bf16 weights written in the same pass), held bit for bit against
    its plain version from the same state. Library yardstick:
    torch._fused_adam_ over the same members as f32 weights and f32
    grads, with no bf16 weight to write (24 bytes per element against
    the sweep's 28): the nearest single PyTorch call, timed only."""
    from mxnet_tpu_torch.kernels import adam_sweep_reference, fused_adam_sweep

    shapes = _pretrain_shapes()
    n = sum(int(np.prod(s)) for s in shapes)

    def members(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ws = [torch.randn(s, device="cuda", generator=g) for s in shapes]
        gs = [torch.randn(s, device="cuda", generator=g).to(torch.bfloat16)
              for s in shapes]
        ms = [0.01 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        vs = [1e-4 * torch.rand(s, device="cuda", generator=g)
              for s in shapes]
        return ws, gs, ms, vs, [w.to(torch.bfloat16) for w in ws]

    lrs = [1e-4 * (1 - 0.999) ** 0.5 / (1 - 0.9)] * len(shapes)
    wds = [0.0] * len(shapes)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=1.0)
    a = members(5)
    fused_adam_sweep(*a, lrs, wds, **kw)
    b = members(5)
    adam_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for grp in range(5)
               for x, y in zip(a[grp], b[grp]))
    err = max(float((x.float() - y.float()).abs().max())
              for grp in (0, 2, 3, 4) for x, y in zip(a[grp], b[grp]))
    del b
    ms = time_ms(lambda: fused_adam_sweep(*a, lrs, wds, **kw), flush)
    plain_ms = time_ms(lambda: adam_sweep_reference(*a, lrs, wds, **kw),
                       flush, iters=5, warmup=1)
    ws, gs, m1, v1, _ = a
    g32 = [g.float() for g in gs]
    steps = [torch.ones((), device="cuda") for _ in shapes]
    library_ms = time_ms(lambda: torch._fused_adam_(
        ws, g32, m1, v1, [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), flush)
    # bf16 grad read; f32 master, mean, var read and written; bf16 weight
    # written. ~15 f32 operations per element
    b_ms, b_by = bound(28.0 * n, 15.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_adam_sweep",
           "shape": [n], "members": len(shapes), "dtype": "bfloat16-mp",
           "bit_identical": same, "max_abs_err": err, "ok": same,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_adam_ on f32 weights and f32 grads, "
                      "no bf16 weight written",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 28.0 * n / 1e9}
    emit(rec)
    del a, ws, gs, m1, v1, g32
    torch.cuda.empty_cache()
    return rec


def _proxy1b_shapes() -> list:
    """The trainable parameter shapes of the proxy1b Llama (tools/
    pretrain_llama.py's config, 700.5M parameters)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_proxy1b

    net = llama_proxy1b(ctx="cuda", dtype=torch.bfloat16)
    shapes = [tuple(p.shape) for p in net.parameters()]
    del net
    torch.cuda.empty_cache()
    return shapes


def adamw_case(flush, gen) -> dict:
    """The AdamW scan and sweep over the proxy1b Llama's bf16
    multi-precision parameter set (f32 masters and moments, bf16 grads,
    the bf16 weights written in the same pass), with the pretraining tool's
    hyperparameters, held bit for bit against the plain version from the
    same state. The final norm's gradient holds a NaN and the first
    attn_norm's an inf: both members must keep their weights and moments
    bit for bit (no clip). Library yardstick: torch._fused_adamw_ over
    the same members as f32 weights and f32 grads, with no bf16 weight
    to write and no overflow scan (24 bytes per element against 30), and
    torch.optim.AdamW's semantics (wd times the uncorrected lr, eps
    inside the bias correction): the nearest single call, timed only.
    Bytes: the scan reads the bf16 grad (2 per element), the sweep 28."""
    from mxnet_tpu_torch.kernels import (adamw_sweep_reference,
                                         fused_adamw_sweep)

    shapes = _proxy1b_shapes()
    n = sum(int(np.prod(s)) for s in shapes)
    nan_j, inf_j = len(shapes) - 2, 1       # norm.weight, blocks.0.attn_norm

    def members(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ws = [0.02 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        gs = [(1e-3 * torch.randn(s, device="cuda", generator=g)).to(
            torch.bfloat16) for s in shapes]
        gs[nan_j].view(-1)[7] = float("nan")
        gs[inf_j].view(-1)[3] = float("inf")
        ms = [1e-4 * torch.randn(s, device="cuda", generator=g)
              for s in shapes]
        vs = [1e-8 * torch.rand(s, device="cuda", generator=g)
              for s in shapes]
        return ws, gs, ms, vs, [w.to(torch.bfloat16) for w in ws]

    lrs = [3e-4 * (1 - 0.95 ** 3) ** 0.5 / (1 - 0.9 ** 3)] * len(shapes)
    wds = [0.1] * len(shapes)
    kw = dict(beta1=0.9, beta2=0.95, epsilon=1e-6, rescale_grad=1.0)
    a = members(6)
    start = [[t.clone() for t in (a[0][j], a[2][j], a[3][j])]
             for j in (nan_j, inf_j)]
    fused_adamw_sweep(*a, lrs, wds, **kw)
    b = members(6)
    adamw_sweep_reference(*b, lrs, wds, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for grp in (0, 2, 3, 4)
               for x, y in zip(a[grp], b[grp]))
    kept = all(torch.equal(x, y) for j, old in zip((nan_j, inf_j), start)
               for x, y in zip((a[0][j], a[2][j], a[3][j]), old))
    err = max(float((x.float() - y.float()).abs().nan_to_num().max())
              for grp in (0, 2, 3, 4) for x, y in zip(a[grp], b[grp]))
    del b, start
    ms = time_ms(lambda: fused_adamw_sweep(*a, lrs, wds, **kw), flush)
    plain_ms = time_ms(lambda: adamw_sweep_reference(*a, lrs, wds, **kw),
                       flush, iters=5, warmup=1)
    ws, gs, m1, v1, _ = a
    g32 = [g.float().nan_to_num() for g in gs]
    steps = [torch.ones((), device="cuda") for _ in shapes]
    library_ms = time_ms(lambda: torch._fused_adamw_(
        ws, g32, m1, v1, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-6, amsgrad=False, maximize=False), flush)
    # ~15 f32 operations per element in the sweep, 3 in the scan
    b_ms, b_by = bound(30.0 * n, 18.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_adamw_sweep",
           "shape": [n], "members": len(shapes), "dtype": "bfloat16-mp",
           "bit_identical": same, "overflowed_members_kept": kept,
           "max_abs_err": err, "ok": same and kept,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_adamw_ on f32 weights and f32 grads, "
                      "no bf16 weight written, no scan, torch's AdamW "
                      "semantics",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 30.0 * n / 1e9,
           "bound_ms_scan": 2.0 * n / HBM_BYTES_PER_S * 1e3,
           "bound_ms_sweep": 28.0 * n / HBM_BYTES_PER_S * 1e3}
    emit(rec)
    del a, ws, gs, m1, v1, g32
    torch.cuda.empty_cache()
    return rec


def _resnet50_members() -> list:
    """ResNet-50 v1's trainable parameters as the main path holds them
    (``resnet50_v1(layout="NHWC")`` in bf16: channels-last convolution
    weights, f32 BatchNorm), one empty tensor of each's shape, dtype and
    memory layout."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    net = resnet50_v1(layout="NHWC", ctx="cuda", dtype=torch.bfloat16)
    like = [torch.empty_like(p.detach()) for p in net.parameters()]
    del net
    torch.cuda.empty_cache()
    return like


def _bits(t):
    """``t``'s bits as integers, so NaNs compare equal bit for bit."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def sgd_case(flush, gen) -> dict:
    """The fused SGD sweep over ResNet-50's parameter set in the step's
    two buckets, with the path's hyperparameters (lr 0.1, momentum 0.9,
    wd 0): the bf16 multi-precision bucket (25.50M elements: f32 masters
    and momenta, bf16 grads, the bf16 weights written in the same pass,
    the convolution weights channels-last) and the f32 BatchNorm bucket
    (53k elements, f32 momenta), held bit for bit against the plain
    version from the same state, with momentum 0.9 and with none (the
    momentum-free form), and with one member's grad holding a NaN and
    another's an inf (compared as bits: SGD propagates them, as the
    reference). ms: both buckets' launches, as a step runs them.
    Library yardstick: torch._fused_sgd_ over the same f32 masters with
    f32 grads and its own momentum convention (buf = m * buf + g, w -=
    lr * buf), no bf16 weight written: the nearest single PyTorch call,
    timed only. Bytes per element: bf16-mp 20 (read g 2, w 4, mom 4;
    write w 4, mom 4, w_low 2), f32 20 (read g, w, mom; write w, mom)."""
    from mxnet_tpu_torch.kernels import fused_sgd_sweep, sgd_sweep_reference

    like = _resnet50_members()
    low_like = [t for t in like if t.dtype == torch.bfloat16]
    f32_like = [t for t in like if t.dtype == torch.float32]
    n_mp = sum(t.numel() for t in low_like)
    n_f32 = sum(t.numel() for t in f32_like)
    nan_j, inf_j = 3, len(low_like) - 1      # a 1x1 conv, the Dense bias

    def members(seed, momentum):
        g = torch.Generator(device="cuda").manual_seed(seed)

        def rand(t, dtype, scale):
            out = torch.empty_like(t, dtype=torch.float32)
            return (scale * out.normal_(generator=g)).to(dtype)

        mp = [[rand(t, torch.float32, 0.05) for t in low_like],
              [rand(t, torch.bfloat16, 1e-2) for t in low_like],
              [rand(t, torch.float32, 1e-3) for t in low_like]
              if momentum else None]
        mp.append([w.to(torch.bfloat16) for w in mp[0]])
        mp[1][nan_j].view(-1)[5] = float("nan")
        mp[1][inf_j].view(-1)[2] = float("inf")
        f32 = [[1.0 + rand(t, torch.float32, 0.1) for t in f32_like],
               [rand(t, torch.float32, 1e-2) for t in f32_like],
               [rand(t, torch.float32, 1e-3) for t in f32_like]
               if momentum else None, None]
        return mp, f32

    def run(fn, buckets, momentum):
        for ws, gs, moms, lows in buckets:
            fn(ws, gs, moms, lows, [0.1] * len(ws), [0.0] * len(ws),
               momentum=momentum, rescale_grad=1.0)

    same, err = True, 0.0
    for momentum in (0.9, 0.0):
        a, b = members(9, momentum), members(9, momentum)
        run(fused_sgd_sweep, a, momentum)
        run(sgd_sweep_reference, b, momentum)
        torch.cuda.synchronize()
        for ba, bb in zip(a, b):
            for grp in (0, 2, 3):
                if ba[grp] is None:
                    continue
                for x, y in zip(ba[grp], bb[grp]):
                    same &= torch.equal(_bits(x), _bits(y))
                    err = max(err, float((x.float() - y.float()).abs()
                                         .nan_to_num().max()))
        del b
    nan_kept = bool(torch.isnan(a[0][0][nan_j]).any()
                    and torch.isinf(a[0][0][inf_j]).any())
    a = members(9, 0.9)
    ms = time_ms(lambda: run(fused_sgd_sweep, a, 0.9), flush)
    ms_mp = time_ms(lambda: run(fused_sgd_sweep, a[:1], 0.9), flush)
    ms_f32 = time_ms(lambda: run(fused_sgd_sweep, a[1:], 0.9), flush)
    plain_ms = time_ms(lambda: run(sgd_sweep_reference, a, 0.9), flush,
                       iters=5, warmup=1)
    ws = [w.contiguous() for w in a[0][0] + a[1][0]]
    gs = [g.float().nan_to_num().contiguous() for g in a[0][1] + a[1][1]]
    bufs = [m.contiguous() for m in a[0][2] + a[1][2]]
    library_ms = time_ms(lambda: torch._fused_sgd_(
        ws, gs, bufs, weight_decay=0.0, momentum=0.9, lr=0.1,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False),
        flush)
    n = n_mp + n_f32
    # ~6 f32 operations per element
    b_ms, b_by = bound(20.0 * n, 6.0 * n, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_sgd_sweep",
           "shape": [n_mp, n_f32], "members": [len(low_like),
                                               len(f32_like)],
           "dtype": "bfloat16-mp + float32",
           "bit_identical": same, "nonfinite_propagated": nan_kept,
           "max_abs_err": err, "ok": same and nan_kept,
           "ms": ms, "ms_bf16_mp_bucket": ms_mp, "ms_f32_bucket": ms_f32,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch._fused_sgd_ on the f32 masters and f32 "
                      "grads of both buckets, torch's momentum "
                      "convention, no bf16 weight written",
           "bound_ms": b_ms, "bound_by": b_by, "gbytes": 20.0 * n / 1e9,
           "bound_ms_bf16_mp_bucket": 20.0 * n_mp / HBM_BYTES_PER_S * 1e3}
    emit(rec)
    del a, ws, gs, bufs
    torch.cuda.empty_cache()
    return rec


def _warm_card(seconds=2.0) -> None:
    """Keep the card busy with bf16 GEMMs for ``seconds`` so its clocks
    have ramped up before anything is timed."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _warm_card()
    flush = _L2Flush()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rs = np.random.RandomState(SEED)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (8, 8 * 512):
            recs.append(rms_case(rows, 4096, dtype, flush, gen))
        for b in (1, 8, 32):
            recs.append(paged_case(b, dtype, flush, rs, gen))
        # the BERT path's shapes: batch 32 x seq 512, BERT-base widths
        for with_res in (True, False):
            recs.append(ln_case(32 * 512, 768, dtype, with_res, flush, gen))
        recs.append(gelu_case(32 * 512, 3072, dtype, flush, gen))
        # BERT's heads as the path hands them over (views of the fused
        # QKV output), and a causal (2, 8, 2048, 128) for the streaming
        # TPU site
        for shape in ((32, 12, 512, 64, False, "blhd"),
                      (8, 12, 128, 64, False, "blhd"),
                      (2, 8, 2048, 128, True, "bhld")):
            recs.append(flash_case(*shape, dtype, flush, gen))
        # the pretraining path's backward kernels at its shapes
        for with_res in (True, False):
            recs.append(ln_bwd_case(32 * 512, 768, dtype, with_res, flush,
                                    gen))
        recs.append(gelu_bwd_case(32 * 512, 3072, dtype, flush, gen))
        for shape in ((32, 12, 512, 64, False, "blhd"),
                      (2, 8, 2048, 128, True, "bhld")):
            recs.append(flash_bwd_case(*shape, dtype, flush, gen))
        # the dropout modes at p = 0.1, at the pretraining path's shapes
        recs.append(hash_dropout_case((32, 512, 768), dtype, flush, gen))
        for with_res in (True, False):
            recs.extend(ln_drop_cases(32 * 512, 768, dtype, with_res, flush,
                                      gen))
        for shape in ((32, 12, 512, 64, False, "blhd"),
                      (2, 8, 2048, 128, True, "bhld")):
            recs.extend(flash_drop_cases(*shape, dtype, flush, gen))
        for d in (64, 128):
            recs.append(flash_mask_case(d, dtype, flush, gen))
        # the Llama pretraining path's shapes (proxy1b at 8 x 2048): the
        # RMSNorm forward with its rstd and its backward, and causal
        # flash on contiguous (8, 2048, 16, 128) heads, GQA repeated
        recs.append(rms_case(8 * 2048, 2048, dtype, flush, gen, rstd=True))
        recs.append(rms_bwd_case(8 * 2048, 2048, dtype, flush, gen))
        recs.append(flash_case(8, 16, 2048, 128, True, "blhd", dtype, flush,
                               gen, views=False))
        recs.append(flash_bwd_case(8, 16, 2048, 128, True, "blhd", dtype,
                                   flush, gen, views=False))
    recs.append(adam_case(flush, gen))
    recs.append(adamw_case(flush, gen))
    recs.append(sgd_case(flush, gen))
    bad = [r for r in recs if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    del flush
    torch.cuda.empty_cache()
    # each kernel's main-path shape stands for it in the summary: the
    # decode step's RMS (8, 4096) and paged B = 8, and BERT-base's
    # (32 x 512) batch for LayerNorm with the residual (24 of its 25
    # calls per forward, 24 of 26 backward), bias+GELU and flash
    # attention on fused-QKV views, forward and backward; bf16, and the
    # sweeps over the bf16-mp parameter sets; the RMSNorm backward at the
    # proxy1b step's (8 x 2048, 2048)
    pick = {r["kernel"]: r for r in recs
            if r["kernel"] in ("fused_adam_sweep", "fused_adamw_sweep",
                               "fused_sgd_sweep")}
    for r in recs:
        if r["dtype"] != "bfloat16":
            continue
        if r["kernel"] == "fused_rms_norm_bwd":
            pick["fused_rms_norm_bwd"] = r
        if r["kernel"] == "fused_layer_norm_bwd" and r["residual"]:
            pick["fused_layer_norm_bwd"] = r
        if r["kernel"] == "fused_bias_gelu_bwd":
            pick["fused_bias_gelu_bwd"] = r
        if r["kernel"] == "flash_attention_bwd" and r["layout"] == "blhd" \
                and r["views"]:
            pick["flash_attention_bwd"] = r
        if r["kernel"] == "fused_rms_norm" and r["shape"] == [8, 4096]:
            pick["fused_rms_norm"] = r
        if r["kernel"] == "paged_attention_kernel" and r["shape"]["B"] == 8:
            pick["paged_attention_kernel"] = r
        if r["kernel"] == "fused_layer_norm" and r["residual"]:
            pick["fused_layer_norm"] = r
        if r["kernel"] == "fused_bias_gelu":
            pick["fused_bias_gelu"] = r
        if r["kernel"] == "flash_attention" and r["shape"] == [32, 12, 512,
                                                               64] \
                and r["layout"] == "blhd":
            pick["flash_attention"] = r
        # the dropout modes: the residual LayerNorm (the 12 add+norms
        # that drop), flash on the fused-QKV views, the Dropout op
        if r["kernel"] in ("fused_layer_norm[dropout]",
                           "fused_layer_norm_bwd[dropout]") \
                and r["residual"]:
            pick[r["kernel"]] = r
        if r["kernel"] in ("flash_attention[dropout]",
                           "flash_attention_bwd[dropout]") \
                and r["layout"] == "blhd":
            pick[r["kernel"]] = r
        if r["kernel"] == "hash_dropout":
            pick["hash_dropout"] = r
    return pick


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------

class _LogitsTap:
    """Keeps the logits each engine dispatch returned. The scheduler
    emits a dispatch's tokens in row order right after it returns, so
    the k-th on_token callback after a dispatch belongs to row k."""

    def __init__(self, engine):
        self.last = None
        self.row = 0
        for name in ("prefill", "decode_step"):
            setattr(engine, name, self._wrap(getattr(engine, name)))

    def _wrap(self, fn):
        def run(*args):
            self.last = fn(*args)
            self.row = 0
            return self.last
        return run

    def take(self) -> np.ndarray:
        row = self.last[self.row]
        self.row += 1
        return row


def _serve(net, dtype, prompts, new_tokens, tol, **server_kw) -> tuple:
    """Serve ``prompts`` concurrently through ``serving.Server`` after one
    warm-up request, then hold each stream's last decode-step logits
    against ``forward_full`` over the same tokens: the largest |diff|
    must stay within ``tol`` times the largest |logit|. Kernel launch
    counts are zeroed just before the streams are submitted and read
    just after they complete. Returns (results, the server's engine)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import (fused_rms_norm,
                                         paged_attention_kernel)

    n = len(prompts)
    srv = mx.serving.Server(net, dtype=dtype, **server_kw)
    with srv:
        tap = _LogitsTap(srv.engine)
        # warm-up: one short request through both phases (cuBLAS picks
        # its kernels; the kernels' libraries load)
        srv.submit_generate(prompts[0][:16], 2).result(600)
        torch.cuda.synchronize()

        last_logits = [None] * n
        times = [[] for _ in range(n)]

        def on_token(s):
            def cb(i, tok):
                times[s].append(time.perf_counter())
                last_logits[s] = tap.take()
            return cb

        torch.cuda.reset_peak_memory_stats()
        fused_rms_norm.launches = 0
        paged_attention_kernel.launches = 0
        t_start = time.perf_counter()
        handles, t_submit = [], []
        for s, p in enumerate(prompts):
            t_submit.append(time.perf_counter())
            handles.append(srv.submit_generate(p, new_tokens,
                                               on_token=on_token(s)))
        outs = [h.result(600) for h in handles]
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {"fused_rms_norm": fused_rms_norm.launches,
                    "paged_attention_kernel": paged_attention_kernel.launches}
        stats = srv.stats()
    if any(len(o) != new_tokens for o in outs):
        fail(f"a stream did not complete: {[len(o) for o in outs]}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    ttft = [times[s][0] - t_submit[s] for s in range(n)]
    per_tok = [(times[s][-1] - times[s][0]) / (new_tokens - 1)
               for s in range(n)]
    errs, rel, agree = [], [], 0
    for s in range(n):
        seq = np.concatenate([prompts[s], outs[s][:-1]])[None, :]
        full = srv.engine.forward_full(seq)[0]
        dec = last_logits[s]
        if int(np.argmax(dec)) != int(outs[s][-1]):
            fail(f"stream {s}: tapped logits do not match its last token")
        err = float(np.max(np.abs(dec - full)))
        errs.append(err)
        rel.append(err / float(np.max(np.abs(full))))
        agree += int(np.argmax(dec) == np.argmax(full))
    finite = bool(all(np.isfinite(lg).all() for lg in last_logits))
    out = {"streams": n, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": new_tokens,
           "tokens_per_s": n * new_tokens / (t_end - t_start),
           "wall_s": t_end - t_start,
           "ttft_ms": {"mean": 1e3 * float(np.mean(ttft)),
                       "max": 1e3 * float(np.max(ttft))},
           "per_token_ms": {"mean": 1e3 * float(np.mean(per_tok)),
                            "max": 1e3 * float(np.max(per_tok))},
           "launches": launches, "batches": stats["batches"],
           "defrags": stats["defrags"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "vs_forward_full": {"max_abs_err": errs,
                               "err_over_max_logit": rel, "tolerance": tol,
                               "argmax_agree": f"{agree}/{n}",
                               "finite": finite}}
    if not finite or max(rel) > tol:
        fail(f"decode logits disagree with forward_full: {out}")
    return out, srv.engine


def _prompts(rs, n, lo, hi, vocab) -> list:
    lens = rs.choice(np.arange(lo, hi + 1), n, replace=False)
    return [rs.randint(0, vocab, size=int(k)).astype(np.int32)
            for k in lens]


def phase_reference() -> None:
    """The decode path at Llama-3-8B widths in f32, depth cut to 2
    layers: cached decode must match a full recompute to f32 noise
    (1e-3 of the largest logit; a wrong page, mask or position would
    move the logits by O(1))."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    net = llama_3_8b(num_layers=2, ctx=mx.gpu(0), dtype=torch.float32,
                     generator=gen)
    rs = np.random.RandomState(SEED + 1)
    res, _ = _serve(net, "float32", _prompts(rs, 4, 20, 120, 128256), 8,
                 tol=1e-3, batch_buckets=(1, 2, 4), len_buckets=(128,),
                 decode_pages=128, page_size=16)
    emit({"phase": "reference", "model": "llama_3_8b(num_layers=2)",
          "dtype": "float32", **res})
    del net
    torch.cuda.empty_cache()


def phase_serving() -> dict:
    """Llama-3-8B, all 32 layers, bf16. The decode path (paged kernel,
    K/V written by earlier dispatches' GEMM shapes) and forward_full (one
    prefill, bf16 scores in the gather path) round bf16 at different
    places over 32 layers: each stream's logits must agree within 10% of
    the largest logit magnitude, and the argmax agreement is reported."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = llama_3_8b(ctx=mx.gpu(0), dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    cfg = net._decode_cfg
    n_params = sum(p.numel() for p in net.parameters())
    emit({"phase": "serving", "step": "model", "config": cfg,
          "params": n_params, "dtype": "bfloat16",
          "build_s": time.perf_counter() - t0})
    if (cfg["num_layers"], cfg["units"], cfg["num_heads"],
            cfg["num_kv_heads"], cfg["vocab_size"]) != (32, 4096, 32, 8,
                                                        128256):
        fail(f"not Llama-3-8B at full width: {cfg}")
    rs = np.random.RandomState(SEED)
    res, engine = _serve(net, "bfloat16",
                 _prompts(rs, N_STREAMS, 100, 500, cfg["vocab_size"]),
                 NEW_TOKENS, tol=0.1, batch_buckets=(1, 2, 4, 8),
                 len_buckets=(128, 512), decode_pages=512, page_size=16)
    emit({"phase": "serving", "step": "generate", **res})
    emit({"phase": "serving", "step": "decode_breakdown",
          **_decode_breakdown(engine, rs, cfg["vocab_size"])})
    return res["launches"]


def _device_breakdown(step, steps, n_top=8, kind=None) -> dict:
    """Where ``step()``'s time goes: host wall time per call (synchronised,
    unprofiled, after one warm call) against the device time
    torch.profiler records over as many further calls, the ``n_top``
    device events that take most of it, and device time by kind
    (``kind(name)``, default :func:`_kind`)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()                        # host clock, unprofiled
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    device_ms, top, by_kind = _device_events(prof, steps, n_top,
                                             kind or _kind)
    return {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
            "device_idle_share": 1 - device_ms / host_ms,
            "top_device_ms_per_step": top,
            "device_ms_per_step_by_kind": by_kind,
            "port_kernels_per_step": _port_kernel_times(prof, steps)}


# the port's own CUDA kernels, by their __global__ names in kernels/csrc
_PORT_KERNELS = ("flash_fwd_kernel", "dkdv_kernel", "dq_kernel",
                 "delta_kernel", "ln_vec_kernel", "ln_scalar_kernel",
                 "ln_bwd_kernel", "bias_gelu", "adam_kernel", "rms_norm",
                 "paged_decode_kernel", "dropout_kernel", "adamw_kernel",
                 "adamw_scan_kernel", "sgd_kernel")


def _kind(name) -> str:
    if any(k in name for k in _PORT_KERNELS):
        return "port_kernels"
    if any(k in name.lower() for k in ("nvjet", "gemm", "cutlass", "xmma")):
        return "library_gemm"
    if "Memcpy" in name or "Memset" in name:
        return "copy_memset"
    return "other_library"


def _device_events(prof, per, n_top=8, kind=None) -> tuple:
    """(device ms, the ``n_top`` largest device events in ms, device ms by
    kind: the port's kernels, library GEMMs, copies, other library
    kernels), each divided by ``per``. Device-side events only (kernels,
    copies, memsets): a CPU op's device time repeats its kernels' time."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device ms by event name, cut to 60 characters (names that share
    # the cut prefix add up)
    by_name, by_kind = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or dev_us(e) <= 0:
            continue
        ms = dev_us(e) / 1e3 / per
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + ms
        k = (kind or _kind)(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return sum(by_name.values()), dict(top[:n_top]), by_kind


def _port_kernel_times(prof, per) -> dict:
    """Each of the port's kernels (its name with the template arguments,
    so a dropout instance stands apart) by device ms and launches per
    step, and device microseconds per launch: the kernel's own time,
    without the wrapper's host time that an event-timed call may
    include."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type != DeviceType.CUDA or us <= 0 \
                or _kind(e.key) != "port_kernels":
            continue
        name = e.key.split("(anonymous namespace)::", 1)[-1].split("(")[0]
        rec = out.setdefault(name, {"ms": 0.0, "launches": 0})
        rec["ms"] += us / 1e3 / per
        rec["launches"] += e.count / per
    for rec in out.values():
        rec["us_per_launch"] = 1e3 * rec["ms"] / rec["launches"]
    return out


def _decode_breakdown(engine, rs, vocab, batch=8, steps=8) -> dict:
    """A (batch, 1) decode step's host vs device time; rows hold
    300-token prompts, as in the serving phase."""
    owners = [object() for _ in range(batch)]
    width = engine.pool.pages_for(768)
    table = np.zeros((batch, width), np.int32)
    tokens = rs.randint(0, vocab, size=(batch, 512)).astype(np.int32)
    state = {"lengths": np.full((batch,), 300, np.int32)}
    try:
        for i, o in enumerate(owners):
            table[i, :engine.pool.pages_for(300 + 2 * steps + 2)] = \
                engine.pool.alloc(o, 300 + 2 * steps + 2)
        state["nxt"] = np.argmax(engine.prefill(tokens, state["lengths"],
                                                table), -1)
        engine.decode_step(state["nxt"], state["lengths"] + 1, table)

        def step():
            state["lengths"] = state["lengths"] + 1
            state["nxt"] = np.argmax(engine.decode_step(
                state["nxt"], state["lengths"], table), -1)

        res = _device_breakdown(step, steps)
    finally:
        for o in owners:
            engine.pool.free(o)
    return {"batch": batch, "context": 300, **res}


# ---------------------------------------------------------------------------
# 6-7. BERT through Server.submit
# ---------------------------------------------------------------------------

def _bert_counts():
    from mxnet_tpu_torch.kernels import (flash_attention, fused_bias_gelu,
                                         fused_layer_norm)

    return {"fused_layer_norm": fused_layer_norm.launches,
            "flash_attention": flash_attention.launches,
            "fused_bias_gelu": fused_bias_gelu.launches}


def _reset_bert_counts() -> None:
    from mxnet_tpu_torch.kernels import (flash_attention, fused_bias_gelu,
                                         fused_layer_norm)

    fused_layer_norm.launches = 0
    flash_attention.launches = 0
    fused_bias_gelu.launches = 0


def _bert_samples(rs, n, vocab, lo=16, hi=512) -> list:
    """``n`` token-id samples, lengths uniform in [lo, hi], ids uniform in
    [1, vocab)."""
    lens = rs.randint(lo, hi + 1, size=n)
    return [rs.randint(1, vocab, size=int(k)).astype(np.float32)
            for k in lens]


def _serve_bert(net, samples, n_clients, **server_kw) -> dict:
    """Serve ``samples`` through Server.submit from ``n_clients`` threads,
    each submitting its contiguous share back to back and then waiting.
    The launch counters are zeroed after the server's warm-up and just
    before the first submit, and read once the last future resolved;
    a forward pre-hook records each dispatched batch's shape."""
    import mxnet_tpu_torch as mx

    n = len(samples)
    shapes = []
    hook = net.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape)))
    results = [None] * n
    t_sub = [0.0] * n
    t_done = [0.0] * n
    per = -(-n // n_clients)
    try:
        with mx.serving.Server(net, ctx=mx.gpu(0), **server_kw) as srv:
            torch.cuda.synchronize()
            warm = srv.stats()["warmup_forwards"]
            del shapes[:]
            _reset_bert_counts()

            def client(c):
                futs = []
                for i in range(c * per, min(n, (c + 1) * per)):
                    t_sub[i] = time.perf_counter()
                    f = srv.submit(samples[i])
                    f.add_done_callback(
                        lambda _f, i=i: t_done.__setitem__(
                            i, time.perf_counter()))
                    futs.append((i, f))
                for i, f in futs:
                    results[i] = f.result(600)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _bert_counts()
            stats = srv.stats()
    finally:
        hook.remove()
    if any(r is None for r in results):
        fail(f"{sum(r is None for r in results)} of {n} requests were "
             "not served")
    lat_ms = 1e3 * (np.asarray(t_done) - np.asarray(t_sub))
    return {"results": results, "shapes": shapes, "wall": wall,
            "launches": launches, "stats": stats, "lat_ms": lat_ms,
            "warmup_forwards": warm}


def _fold(acc, got, ref) -> tuple:
    """Fold one sample's leaves into ``acc``: (largest |got - ref| per
    leaf, largest |ref| per leaf) over the samples seen so far."""
    e = [float(np.max(np.abs(g - r))) for g, r in zip(got, ref)]
    m = [float(np.max(np.abs(r))) for r in ref]
    if acc is None:
        return e, m
    return ([max(x, y) for x, y in zip(acc[0], e)],
            [max(x, y) for x, y in zip(acc[1], m)])


def _verdict(acc, tol) -> dict:
    rel = [e / m for e, m in zip(*acc)]
    return {"max_abs_err": acc[0], "max_abs_output": acc[1],
            "err_over_max_output": rel, "tolerance": tol,
            "ok": max(rel) <= tol}


def _leaves(out) -> list:
    """Row 0 of each output leaf of a batch-1 forward, as f32 numpy."""
    out = out if isinstance(out, tuple) else (out,)
    return [a[0].float().cpu().numpy() for a in out]


def _check_bert(net, samples, served, tol, buckets, plain=None) -> dict:
    """Each served response against a batch-1 forward of its padded
    sample on the card, leaf by leaf: the largest |diff| over all samples
    must stay within ``tol`` times the largest |output| of that leaf.
    With ``plain`` (the same weights on the CPU, whose tensors take every
    kernel's plain version), each batch-1 forward is also held against
    ``plain``'s forward of the same sample, within ``tol`` likewise."""
    batched, vs_plain = None, None
    with torch.inference_mode():
        for s, got in zip(samples, served["results"]):
            length = next(b for b in buckets if b >= len(s))
            padded = torch.zeros((1, length), dtype=torch.float32)
            padded[0, :len(s)] = torch.from_numpy(s)
            alone = _leaves(net(padded.cuda()))
            got = got if isinstance(got, tuple) else (got,)
            if not all(np.isfinite(g).all() for g in got):
                fail("a served BERT response is not finite")
            batched = _fold(batched, got, alone)
            if plain is not None:
                vs_plain = _fold(vs_plain, alone, _leaves(plain(padded)))
    out = {"vs_batch1": _verdict(batched, tol)}
    if plain is not None:
        out["batch1_vs_plain"] = _verdict(vs_plain, tol)
    return out


def _bert_summary(served, samples, net_cfg, per_forward) -> dict:
    stats = served["stats"]
    shapes = served["shapes"]
    forwards = len(shapes)
    want = {k: v * forwards for k, v in per_forward.items()}
    lat = served["lat_ms"]
    return {"requests": len(samples),
            "requests_per_s": len(samples) / served["wall"],
            "real_tokens_per_s": sum(len(s) for s in samples)
            / served["wall"],
            "padded_tokens_per_s": sum(b * l for b, l in shapes)
            / served["wall"],
            "wall_s": served["wall"],
            "latency_ms": {"p50": float(np.percentile(lat, 50)),
                           "p99": float(np.percentile(lat, 99)),
                           "max": float(np.max(lat))},
            "batches": stats["batches"], "forwards": forwards,
            "close_reasons": stats["close_reasons"],
            "mean_occupancy": stats["batch_rows"] / stats["batch_slots"],
            "batch_shapes": sorted(set(shapes)),
            "warmup_forwards": served["warmup_forwards"],
            "launches": served["launches"], "launches_expected": want,
            "launches_per_forward": per_forward, "config": net_cfg}


def _profile_burst(net, samples, buckets) -> dict:
    """The same burst served again under torch.profiler (device activity
    only, so the host pays little for it): the card's busy time over the
    burst's wall time, and the device events that take it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        served = _serve_bert(net, samples, BERT_CLIENTS,
                             shape_buckets=[(b,) for b in buckets],
                             batch_buckets=(1, 2, 4, 8, 16, 32),
                             slo_ms=500.0, batch_timeout_ms=10.0)
    device_ms, top, _ = _device_events(prof, 1)
    wall_ms = served["wall"] * 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": device_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "forwards": len(served["shapes"]),
            "top_device_ms": top}


def _per_forward(cfg, decoder) -> dict:
    layers = cfg["num_layers"]
    return {"fused_layer_norm": 2 * layers + 1 + int(decoder),
            "flash_attention": layers,
            "fused_bias_gelu": layers + int(decoder)}


def phase_bert_reference() -> None:
    """BERT-base widths in f32, depth cut to 2 layers, every output: a
    response served in a batch must equal the batch-1 forward of its
    padded sample, and that forward the plain versions' forward of the
    same weights on the CPU, to f32 noise (1e-4 of the largest output; a
    wrong row, pad, mask, stride or kernel would move it by O(1))."""
    import copy

    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    net = bert_12_768_12(num_layers=2, ctx="cuda", dtype=torch.float32,
                         generator=gen)
    rs = np.random.RandomState(SEED + 2)
    samples = _bert_samples(rs, 24, net.config["vocab_size"])
    buckets = (128, 512)
    served = _serve_bert(net, samples, 4,
                         shape_buckets=[(b,) for b in buckets],
                         batch_buckets=(1, 2, 4, 8), slo_ms=500.0,
                         batch_timeout_ms=10.0)
    per_forward = _per_forward(net.config, decoder=True)
    out = _bert_summary(served, samples, net.config, per_forward)
    out.update(_check_bert(net, samples, served, 1e-4, buckets,
                           plain=copy.deepcopy(net).to("cpu")))
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "bert_reference", "model": "bert_12_768_12("
          "num_layers=2)", "dtype": "float32", **out})
    if not out["vs_batch1"]["ok"]:
        fail(f"f32 BERT responses disagree with batch-1 forwards: "
             f"{out['vs_batch1']}")
    if not out["batch1_vs_plain"]["ok"]:
        fail(f"f32 BERT forwards on the card disagree with the plain "
             f"versions: {out['batch1_vs_plain']}")
    if out["launches"] != out["launches_expected"]:
        fail(f"BERT reference launch counts {out['launches']} are not "
             f"{out['launches_expected']}")
    del net
    torch.cuda.empty_cache()


def phase_bert_serving() -> dict:
    """bert_12_768_12 (12 layers, 768 units, 3072 FFN, 12 heads, vocab
    30522), bf16, no MLM head, behind Server.submit. Each response must
    agree with the batch-1 forward of its padded sample within one bf16
    ulp (2**-7) of the leaf's largest magnitude. Every kernel of the
    path is row-independent and the readings so far were exactly 0.0;
    the ulp leaves room for cuBLAS to sum another GEMM shape (a batch
    of 32 against a batch of 1) in another order, while a wrong row, pad
    or mask would move a response by O(1)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = bert_12_768_12(use_decoder=False, ctx="cuda",
                         dtype=torch.bfloat16, generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"]) != (12, 768, 3072, 12,
                                                     30522):
        fail(f"not BERT-base at full width and depth: {cfg}")
    rs = np.random.RandomState(0)
    samples = _bert_samples(rs, BERT_REQUESTS, cfg["vocab_size"])
    buckets = (128, 512)
    served = _serve_bert(net, samples, BERT_CLIENTS,
                         shape_buckets=[(b,) for b in buckets],
                         batch_buckets=(1, 2, 4, 8, 16, 32), slo_ms=500.0,
                         batch_timeout_ms=10.0)
    per_forward = _per_forward(cfg, decoder=False)
    out = _bert_summary(served, samples, cfg, per_forward)
    out.update(_check_bert(net, samples, served, BF16_ULP, buckets))
    x = torch.from_numpy(np.stack([np.resize(s, 512) for s in
                                   samples[:32]])).cuda()

    def forward():
        with torch.inference_mode():
            net(x)

    out["forward_breakdown"] = {"batch": 32, "seq": 512,
                                **_device_breakdown(forward, 5)}
    out["burst_profile"] = _profile_burst(net, samples, buckets)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "bert_serving", "model": "bert_12_768_12",
          "dtype": "bfloat16", **out})
    if not out["vs_batch1"]["ok"]:
        fail(f"bf16 BERT responses disagree with batch-1 forwards: "
             f"{out['vs_batch1']}")
    if out["launches"] != out["launches_expected"]:
        fail(f"BERT serving launch counts {out['launches']} are not "
             f"{out['launches_expected']} ({per_forward} per forward)")
    del net
    torch.cuda.empty_cache()
    return out["launches"]


# ---------------------------------------------------------------------------
# 8-9. BERT pretraining through TrainStep
# ---------------------------------------------------------------------------

def _train_wrappers() -> dict:
    from mxnet_tpu_torch.kernels import (flash_attention, flash_attention_bwd,
                                         fused_adam_sweep, fused_adamw_sweep,
                                         fused_bias_gelu, fused_sgd_sweep,
                                         fused_bias_gelu_bwd,
                                         fused_layer_norm,
                                         fused_layer_norm_bwd,
                                         fused_rms_norm, fused_rms_norm_bwd,
                                         hash_dropout, hash_dropout_bwd)

    return {f.__name__: f for f in (
        fused_layer_norm, fused_layer_norm_bwd, fused_bias_gelu,
        fused_bias_gelu_bwd, flash_attention, flash_attention_bwd,
        fused_adam_sweep, hash_dropout, hash_dropout_bwd, fused_rms_norm,
        fused_rms_norm_bwd, fused_adamw_sweep, fused_sgd_sweep)}


# the second counters some wrappers keep beside ``launches``
_SUB_COUNTS = (("dropout_launches", "[dropout]"), ("scan_launches", "[scan]"))


def _reset_train_counts() -> None:
    for f in _train_wrappers().values():
        f.launches = 0
        for attr, _ in _SUB_COUNTS:
            if hasattr(f, attr):
                setattr(f, attr, 0)


def _train_counts() -> dict:
    """Each training wrapper's launches; for the LayerNorm and flash
    wrappers also their launches with dropout, as "<name>[dropout]", and
    for the AdamW sweep its scans, as "fused_adamw_sweep[scan]"."""
    out = {}
    for name, f in _train_wrappers().items():
        out[name] = f.launches
        for attr, suffix in _SUB_COUNTS:
            if hasattr(f, attr):
                out[name + suffix] = getattr(f, attr)
    return out


def _per_step(cfg, buckets, dropout=0.0, attn_dropout=0.0) -> dict:
    """Launches of each kernel in one TrainStep of BERTForPretrainFused:
    embed_ln, two add+norms per layer and decoder_ln, forward and
    backward (the first add+norm of each layer drops, with dropout); the
    FFN's and decoder_transform's bias+GELU; one flash attention per
    layer (dropping with attention dropout); the Dropout op after
    embed_ln and after each layer's attention and FFN, forward and
    backward; one sweep per dtype bucket."""
    layers = cfg["num_layers"]
    drop_ln = layers if dropout > 0 else 0
    drop_attn = layers if attn_dropout > 0 else 0
    drop_op = 2 * layers + 1 if dropout > 0 else 0
    return {**dict.fromkeys(_train_counts(), 0),
            "fused_layer_norm": 2 * layers + 2,
            "fused_layer_norm[dropout]": drop_ln,
            "fused_layer_norm_bwd": 2 * layers + 2,
            "fused_layer_norm_bwd[dropout]": drop_ln,
            "fused_bias_gelu": layers + 1,
            "fused_bias_gelu_bwd": layers + 1,
            "flash_attention": layers,
            "flash_attention[dropout]": drop_attn,
            "flash_attention_bwd": layers,
            "flash_attention_bwd[dropout]": drop_attn,
            "fused_adam_sweep": buckets,
            "hash_dropout": drop_op, "hash_dropout_bwd": drop_op}


def phase_train_reference(dropout=0.0, attn_dropout=0.0) -> None:
    """BERTForPretrainFused at BERT-base widths (768 units, 3072 FFN, 12
    heads, vocab 30522, CE chunk 5120), depth cut to 2 layers, f32: three
    TrainStep Adam steps (lr 1e-4) on a (4, 128) batch on the card
    against the same weights and batch on the CPU, which runs every
    kernel's plain version; at ``dropout`` / ``attn_dropout``, each
    device's seed stream is seeded alike, so both runs draw the same step
    seeds and drop the same elements. Limits, set before the first run:
    each step's loss within 1e-5 relative; each parameter's delta over
    the run within 1e-3 of its norm, ‖Δw_card − Δw_cpu‖ / ‖Δw_cpu‖ (Adam
    makes elements whose gradient is f32 noise step by ±lr either way);
    the key third of each QKV bias, whose true gradient is 0 (softmax
    ignores a constant added to every key), held instead to moving less
    than 1% of 3·lr on both sides."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    t0 = time.perf_counter()
    lr, steps = 1e-4, 3
    cpu_net = BERTForPretrainFused(
        num_layers=2, dropout=dropout, attn_dropout=attn_dropout,
        ctx=mx.cpu(), generator=torch.Generator().manual_seed(SEED + 3))
    card_net = copy.deepcopy(cpu_net).cuda()
    units = cpu_net.config["units"]
    w0 = {k: v.detach().clone() for k, v in cpu_net.state_dict().items()}
    rs = np.random.RandomState(SEED + 3)
    tok = rs.randint(0, 30000, (4, 128)).astype(np.int32)
    lab = rs.randint(0, 30000, (4, 128)).astype(np.int32)
    losses, launches = {}, None
    for name, net in (("cpu", cpu_net), ("card", card_net)):
        step = mx.parallel.TrainStep(net, lambda outs, *a: outs, "adam",
                                     loss_only=True,
                                     optimizer_params={"learning_rate": lr})
        mx.random.seed(SEED + 3, ctx=step._device)
        _reset_train_counts()
        losses[name] = [float(step((tok, lab), ())[0])
                        for _ in range(steps)]
        launches = _train_counts()            # the card's run, read last
        buckets = len(step._buckets)
    ratios, key_bias = {}, []
    card_sd = card_net.state_dict()
    for key, start in w0.items():
        dc = (cpu_net.state_dict()[key] - start).flatten()
        dg = (card_sd[key].cpu() - start).flatten()
        if key.endswith("qkv_proj.bias"):
            k_part = torch.arange(units, 2 * units)
            key_bias.append(max(float(dc[k_part].abs().max()),
                                float(dg[k_part].abs().max())))
            keep = torch.ones_like(dc, dtype=torch.bool)
            keep[k_part] = False
            dc, dg = dc[keep], dg[keep]
        norm = float(dc.norm())
        if norm > 0:
            ratios[key] = float((dg - dc).norm()) / norm
        elif float(dg.norm()) != 0.0:
            ratios[key] = float("inf")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _per_step(
        card_net.config, buckets, dropout, attn_dropout).items()}
    out = {"phase": "train_reference",
           "model": "BERTForPretrainFused(num_layers=2)", "dtype": "float32",
           "dropout": dropout, "attn_dropout": attn_dropout,
           "batch": [4, 128], "steps": steps, "lr": lr,
           "losses": losses, "loss_max_rel_diff": loss_rel,
           "loss_tol": 1e-5, "delta_worst": [worst, ratios[worst]],
           "delta_median": float(np.median(list(ratios.values()))),
           "delta_tol": 1e-3, "key_bias_max_abs_delta": max(key_bias),
           "key_bias_tol": 0.01 * steps * lr, "launches": launches,
           "launches_expected": want,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 training losses on the card disagree with the CPU's: "
             f"{losses}")
    if ratios[worst] > 1e-3 or max(key_bias) > 0.01 * steps * lr:
        fail(f"f32 parameter deltas on the card disagree with the CPU's: "
             f"{worst} {ratios[worst]}, key bias {max(key_bias)}")
    if launches != want:
        fail(f"training reference launch counts {launches} are not {want}")
    del cpu_net, card_net
    torch.cuda.empty_cache()


def phase_bert_train(dropout=0.0, attn_dropout=0.0) -> dict:
    """BERTForPretrainFused at bert_12_768_12 (12 layers, 768 units, 3072
    FFN, 12 heads of 64, vocab 30522, max length 512, CE chunk 5120),
    at ``dropout`` / ``attn_dropout`` (BERT's published 0.1 / 0.1, or 0),
    bf16 with multi-precision Adam (lr 1e-4), seeded random weights, one
    (32, 512) batch of RandomState(0) tokens and labels as in
    bench_bert.py: 3 warm-up and 20 timed TrainStep calls. The loss must
    be finite every step and fall over the run; the launches of every
    kernel must be exactly its per-step count times 20."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused

    # an earlier phase's model may still be held by a reference cycle
    # (the Llama-3-8B server's 16 GB of weights): collect it, or the
    # peak below counts it
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    net = BERTForPretrainFused(dropout=dropout, attn_dropout=attn_dropout,
                               ctx="cuda", dtype=torch.bfloat16,
                               generator=gen)
    cfg = net.config
    if (cfg["num_layers"], cfg["units"], cfg["hidden_size"],
            cfg["num_heads"], cfg["vocab_size"], cfg["max_length"],
            cfg["chunk"]) != (12, 768, 3072, 12, 30522, 512, 5120):
        fail(f"not BERT-base at full width and depth: {cfg}")
    mx.random.seed(SEED)
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    lab = torch.from_numpy(rs.randint(0, 30000, (32, 512)).astype(
        np.int32)).cuda()
    step = mx.parallel.TrainStep(
        net, lambda outs, *a: outs, "adam", loss_only=True,
        optimizer_params={"learning_rate": 1e-4, "multi_precision": True})
    warm = [float(step((tok, lab), ())[0]) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(20):
        timed.append(step((tok, lab), ())[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    losses = warm + [float(x) for x in timed]
    per_step = _per_step(cfg, len(step._buckets), dropout, attn_dropout)
    want = {k: v * 20 for k, v in per_step.items()}
    samples_s = 32 * 20 / wall
    out = {"phase": "bert_train", "model": "BERTForPretrainFused "
           "(bert_12_768_12)", "dtype": "bfloat16, multi-precision adam",
           "dropout": dropout, "attn_dropout": attn_dropout,
           "params": sum(p.numel() for p in net.parameters()),
           "config": cfg, "batch": [32, 512], "steps": 20,
           "ms_per_step": wall * 1e3 / 20, "samples_per_s": samples_s,
           "mfu": samples_s * 6 * 110e6 * 512 / 989e12,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches": launches,
           "launches_expected": want, "launches_per_step": per_step,
           # host ms each timed call took to return (no synchronise)
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step((tok, lab), ()),
                                              2, n_top=16)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 BERT-base training loss is not finite or did not fall: "
             f"{losses}")
    if launches != want:
        fail(f"BERT-base training launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del step, net
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 11-12. Llama pretraining through TrainStep with AdamW
# ---------------------------------------------------------------------------

# the pretraining tool's optimizer (mxnet_tpu_torch/tools/pretrain_llama.py)
LLAMA_OPT = {"learning_rate": 3e-4, "wd": 0.1, "beta1": 0.9, "beta2": 0.95,
             "multi_precision": True}


def _llama_per_step(cfg, buckets) -> dict:
    """Launches of each training kernel in one TrainStep of a Llama with
    the fused CE head: two RMSNorms per layer and the final one, forward
    and backward; one causal flash attention per layer, forward and
    backward; one AdamW scan and sweep per dtype bucket; nothing else."""
    layers = cfg["num_layers"]
    return {**dict.fromkeys(_train_counts(), 0),
            "fused_rms_norm": 2 * layers + 1,
            "fused_rms_norm_bwd": 2 * layers + 1,
            "flash_attention": layers, "flash_attention_bwd": layers,
            "fused_adamw_sweep": buckets, "fused_adamw_sweep[scan]": buckets}


def _llama_glue_ms(batch=8, seq=2048, heads=16, kv_heads=8, d=128) -> dict:
    """Device ms of two pieces of plain PyTorch glue around the kernels of
    one proxy1b layer, forward and backward through autograd, event-timed
    with a cold L2: rope on q and k (f32 inside, the JAX op's numerics)
    and the repeat of k and v up to the query heads (GQA). Neither is a
    Pallas site; this says what each costs per layer."""
    from mxnet_tpu_torch.ops.attention import rope

    def leaf(h):
        return torch.randn(batch, seq, h, d, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()

    q, k, v = leaf(heads), leaf(kv_heads), leaf(kv_heads)
    gq, gk = torch.randn_like(q), torch.randn_like(k)
    rep = heads // kv_heads

    def rope_step():
        outs = (rope(q, theta=500000.0), rope(k, theta=500000.0))
        torch.autograd.grad(outs, (q, k), (gq, gk))

    def repeat_step():
        outs = (k.repeat_interleave(rep, dim=2),
                v.repeat_interleave(rep, dim=2))
        torch.autograd.grad(outs, (k, v), (gq, gq))

    flush = _L2Flush()
    return {"rope_q_k_fwd_bwd_ms": time_ms(rope_step, flush),
            "repeat_k_v_fwd_bwd_ms": time_ms(repeat_step, flush)}


def phase_llama_train_reference() -> None:
    """LlamaModel(fused_ce=True) at proxy1b widths (2048 units, 7168 FFN,
    16 heads of 128 over 8 KV heads, vocab 32768, CE chunk 8192), depth
    cut to 2 layers, f32: three TrainStep AdamW steps with the pretraining tool's
    optimizer on a (2, 128) batch on the card against the same weights
    and batch on the CPU, which runs every kernel's plain version.
    Limits, set before the first run: each step's loss within 1e-5
    relative; each parameter's delta over the run within 1e-3 of its
    norm, ||dw_card - dw_cpu|| / ||dw_cpu||."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_proxy1b
    from mxnet_tpu_torch.tools.pretrain_llama import _FusedLossPassthrough

    t0 = time.perf_counter()
    steps = 3
    cpu_net = llama_proxy1b(num_layers=2, fused_ce=True, ctx=mx.cpu(),
                            generator=torch.Generator().manual_seed(SEED + 5))
    card_net = copy.deepcopy(cpu_net).cuda()
    w0 = {k: v.detach().clone() for k, v in cpu_net.state_dict().items()}
    toks = np.random.RandomState(SEED + 5).randint(0, 32768, (2, 129))
    batch = ((toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)),
             ())
    losses, launches = {}, None
    for name, net in (("cpu", cpu_net), ("card", card_net)):
        step = mx.parallel.TrainStep(net, _FusedLossPassthrough(), "adamw",
                                     loss_only=True,
                                     optimizer_params=dict(LLAMA_OPT))
        _reset_train_counts()
        losses[name] = [float(step(*batch)[0]) for _ in range(steps)]
        launches = _train_counts()            # the card's run, read last
        buckets = len(step._buckets)
    ratios = {}
    card_sd = card_net.state_dict()
    for key, start in w0.items():
        dc = (cpu_net.state_dict()[key] - start).flatten()
        dg = (card_sd[key].cpu() - start).flatten()
        ratios[key] = float((dg - dc).norm()) / float(dc.norm())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _llama_per_step(
        {"num_layers": 2}, buckets).items()}
    emit({"phase": "llama_train_reference",
          "model": "llama_proxy1b(num_layers=2, fused_ce=True)",
          "dtype": "float32", "optimizer": LLAMA_OPT, "batch": [2, 128],
          "steps": steps, "losses": losses, "loss_max_rel_diff": loss_rel,
          "loss_tol": 1e-5, "delta_worst": [worst, ratios[worst]],
          "delta_median": float(np.median(list(ratios.values()))),
          "delta_tol": 1e-3, "launches": launches,
          "launches_expected": want, "seconds": time.perf_counter() - t0})
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 Llama training losses on the card disagree with the "
             f"CPU's: {losses}")
    if not ratios[worst] <= 1e-3:
        fail(f"f32 Llama parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}")
    if launches != want:
        fail(f"Llama training reference launch counts {launches} are not "
             f"{want}")
    del cpu_net, card_net, step
    torch.cuda.empty_cache()


def phase_llama_train() -> dict:
    """The proxy1b Llama (tools/pretrain_llama.py's config: 10 layers,
    2048 units, 7168 FFN, 16 heads of 128 over 8 KV heads, vocab 32768,
    700.5M parameters), not cut, built by the port's pretraining tool: bf16
    weights from seed 0, fused CE head, multi-precision AdamW (lr 3e-4,
    wd 0.1, beta 0.9 / 0.95), one (8, 2048) batch of RandomState(0)
    tokens as the pretraining tool's _make_data draws them (bench_llama.py's
    shape): 3 warm-up and 10 timed TrainStep calls. The loss must be
    finite every step and fall over the run; the launches of every
    training kernel must be exactly its per-step count times 10."""
    import gc

    from mxnet_tpu_torch.tools import pretrain_llama

    # the serving and BERT phases' models may still be held by reference
    # cycles: collect them, or the peak below counts them
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, seq, timed_steps = 8, 2048, 10
    cfg = pretrain_llama.CONFIGS["proxy1b"]
    net, step = pretrain_llama.build("proxy1b", ctx="cuda")
    if net._decode_cfg["num_layers"] != 10 or net._ce_chunk != 8192:
        fail(f"not proxy1b at full depth: {net._decode_cfg}")
    n_params = pretrain_llama.param_count(cfg)
    tok, lab = next(pretrain_llama._make_data(
        "synthetic", batch, seq, cfg["vocab_size"], torch.device("cuda")))
    warm = [float(step((tok, lab), ())[0]) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(step((tok, lab), ())[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    losses = warm + [float(x) for x in timed]
    per_step = _llama_per_step(cfg, len(step._buckets))
    want = {k: v * timed_steps for k, v in per_step.items()}
    tokens_s = batch * seq * timed_steps / wall
    out = {"phase": "llama_train", "model": "LlamaModel(fused_ce=True), "
           "proxy1b", "dtype": "bfloat16, multi-precision adamw",
           "optimizer": LLAMA_OPT, "params": n_params,
           "params_counted": sum(p.numel() for p in net.parameters()),
           "config": cfg, "batch": [batch, seq], "steps": timed_steps,
           "ms_per_step": wall * 1e3 / timed_steps,
           "tokens_per_s": tokens_s,
           "mfu": 6.0 * n_params * tokens_s / 989e12,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": losses, "launches": launches,
           "launches_expected": want, "launches_per_step": per_step,
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step((tok, lab), ()),
                                              2, n_top=16)
    out["glue_per_layer"] = _llama_glue_ms()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 proxy1b training loss is not finite or did not fall: "
             f"{losses}")
    if launches != want:
        fail(f"proxy1b training launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del step, net
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 12-13. ResNet-50 v1 training through TrainStep with SGD momentum
# ---------------------------------------------------------------------------

RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}


class _Decisions:
    """The card's ReLU and max-pool decisions, recorded in call order
    during its run and replayed on the CPU copy's. A ReLU network's
    gradient jumps where a ReLU input crosses 0 or two inputs of a
    max-pool window swap places; the card and the CPU round differently,
    so an input within f32 rounding of such a point takes one side on
    one device and the other side on the other, and every gradient
    upstream of it moves by that element's share of its layer's, far
    above the f32 noise the limits allow. Replayed, both devices compute
    the same piecewise-linear function and the comparison reads the ops'
    rounding alone; ``disagreements`` counts the elements where the CPU
    would have decided otherwise, out of ``elements`` replayed."""

    def __init__(self):
        import torch.nn.functional as F

        from mxnet_tpu_torch.ops import nn as ops_nn

        self._ops, self._f = ops_nn, F
        self._max_pool2d = F.max_pool2d
        self.log, self.pos, self.mode = [], 0, None
        self.disagreements = self.elements = 0

    def relu(self, x):
        keep = x > 0
        if self.mode == "record":
            self.log.append(keep.cpu())
            return torch.relu(x)
        want = self.log[self.pos].to(x.device)
        self.pos += 1
        self.disagreements += int((keep != want).sum())
        self.elements += want.numel()
        return torch.where(want, x, torch.zeros((), dtype=x.dtype))

    def max_pool2d(self, x, kernel, stride, pad):
        out, idx = self._max_pool2d(x, kernel, stride, pad,
                                    return_indices=True)
        if self.mode == "record":
            self.log.append(idx.cpu())
            return out
        want = self.log[self.pos].to(x.device)
        self.pos += 1
        self.disagreements += int((idx != want).sum())
        self.elements += want.numel()
        n, c = x.shape[:2]
        return x.reshape(n, c, -1).gather(2, want.reshape(n, c, -1)) \
            .view(want.shape)

    def run(self, mode, fn):
        """``fn()`` with the decisions recorded (``"record"``) or
        replayed (``"replay"``)."""
        self.mode, self.pos = mode, 0
        relu = self._ops._ACTIVATIONS["relu"]
        self._ops._ACTIVATIONS["relu"] = self.relu
        self._f.max_pool2d = self.max_pool2d
        try:
            return fn()
        finally:
            self._ops._ACTIVATIONS["relu"] = relu
            self._f.max_pool2d = self._max_pool2d


def _resnet_per_step(buckets) -> dict:
    """Launches of each training kernel in one TrainStep of a ResNet v1:
    one SGD sweep per dtype bucket and nothing else (convolution,
    BatchNorm, pooling and the loss are library and plain PyTorch
    ops)."""
    return {**dict.fromkeys(_train_counts(), 0), "fused_sgd_sweep": buckets}


def _running_stats(net) -> dict:
    return {k: v.detach().float().cpu().clone()
            for k, v in net.state_dict().items() if "running" in k}


def phase_resnet_train_reference() -> None:
    """resnet18_v1(classes=10, layout="NHWC") at 64x64 (the 7x7 stem, the
    max pool, basic blocks), f32, seeded weights: three TrainStep SGD
    steps (lr 1e-3, momentum 0.9) on a batch of 4 with float labels on
    the card against the same weights and batch on the CPU, which runs
    the plain versions, with TF32 off in cuDNN for the phase (restored
    after it), and the CPU copy taking the card's ReLU and max-pool
    decisions (_Decisions). Limits, set before the first run: each
    step's loss within 1e-5 relative; every running mean and variance
    after each step within 1e-5 + 1e-5 |cpu|; each parameter's delta
    over the run within 1e-3 of its norm; exactly one sweep per step
    and no other training kernel. The replay may cover at most 1e-5 of
    the decisions it replays (about 25 of some 2.5M here; two runs
    found 2), so a fault on the card upstream of a kink, which moves
    many decisions, cannot hide behind it."""
    import copy

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1

    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    steps, opt = 3, {"learning_rate": 1e-3, "momentum": 0.9}
    card_net = resnet18_v1(classes=10, layout="NHWC", ctx="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 7))
    cpu_net = copy.deepcopy(card_net).cpu()
    w0 = {k: v.detach().cpu().clone()
          for k, v in card_net.named_parameters()}
    rs = np.random.RandomState(SEED + 7)
    x = rs.randn(4, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    decisions = _Decisions()
    losses, stats = {}, {}
    for name, net in (("card", card_net), ("cpu", cpu_net)):
        step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                     optimizer_params=dict(opt))
        _reset_train_counts()

        def run():
            got = []
            for _ in range(steps):
                got.append((float(step(x, y)[0]), _running_stats(net)))
            return got

        got = decisions.run("record" if name == "card" else "replay", run)
        losses[name] = [g[0] for g in got]
        stats[name] = [g[1] for g in got]
        if name == "card":
            launches = _train_counts()
            buckets = len(step._buckets)
    torch.backends.cudnn.allow_tf32 = tf32
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                        losses["cpu"]))
    stat_err = max(float(((a[k] - b[k]).abs()
                          - 1e-5 * b[k].abs()).max())
                   for a, b in zip(stats["card"], stats["cpu"]) for k in a)
    ratios = {}
    cpu_params = dict(cpu_net.named_parameters())
    for key, p in card_net.named_parameters():
        dc = (cpu_params[key].detach() - w0[key]).flatten()
        dg = (p.detach().cpu() - w0[key]).flatten()
        ratios[key] = float((dg - dc).norm()) / float(dc.norm())
    worst = max(ratios, key=ratios.get)
    want = {k: v * steps for k, v in _resnet_per_step(buckets).items()}
    emit({"phase": "resnet_train_reference",
          "model": "resnet18_v1(classes=10, layout='NHWC')",
          "dtype": "float32", "optimizer": opt, "batch": [4, 3, 64, 64],
          "steps": steps, "losses": losses, "loss_max_rel_diff": loss_rel,
          "loss_tol": 1e-5, "running_stats_excess_over_tol": stat_err,
          "running_stats_tol": "1e-5 + 1e-5 |cpu|",
          "delta_worst": [worst, ratios[worst]],
          "delta_median": float(np.median(list(ratios.values()))),
          "delta_tol": 1e-3,
          "decisions_replayed": decisions.elements,
          "decision_disagreements": decisions.disagreements,
          "decision_disagreements_limit": 1e-5 * decisions.elements,
          "launches": launches, "launches_expected": want,
          "seconds": time.perf_counter() - t0})
    if not all(np.isfinite(losses["card"])) or loss_rel > 1e-5:
        fail(f"f32 ResNet training losses on the card disagree with the "
             f"CPU's: {losses}")
    if stat_err > 1e-5:
        fail(f"f32 ResNet running statistics on the card disagree with the "
             f"CPU's by {stat_err} over 1e-5 + 1e-5 |cpu|")
    if not ratios[worst] <= 1e-3:
        fail(f"f32 ResNet parameter deltas on the card disagree with the "
             f"CPU's: {worst} {ratios[worst]}")
    if launches != want:
        fail(f"ResNet training reference launch counts {launches} are not "
             f"{want}")
    if decisions.disagreements > 1e-5 * decisions.elements:
        fail(f"the CPU would decide {decisions.disagreements} of "
             f"{decisions.elements} ReLU and max-pool elements otherwise "
             "than the card: more than f32 rounding near a kink explains")
    del cpu_net, card_net, step
    torch.cuda.empty_cache()


def _masters_and_momenta(step) -> list:
    """Each trained parameter's (master, momentum) as f64 copies on the
    card: the f32 master of a bf16 multi-precision parameter, the f32
    parameter itself (BatchNorm's gamma and beta) otherwise."""
    out = []
    for p, st in zip(step._params, step._states):
        w, mom = st if isinstance(st, tuple) else (p.detach(), st)
        out.append((w.double(), mom.double()))
    return out


def _sgd_rule_excess(step, before, opt) -> dict:
    """How far one TrainStep SGD step strayed from its rule, worked by
    hand in f64 from ``before`` (_masters_and_momenta) and each
    parameter's gradient, which the step leaves in ``.grad``: the new
    momentum ``momentum * mom - lr * g`` within 1e-6 of its largest
    term, the new master ``master + mom`` within 1e-6 of the largest
    master (f32 rounding of each operation), each bf16 weight its master
    rounded. ``worst_excess`` is the largest error over its limit (above
    1 breaks the rule); no weight decay, clipping or rescale, as the
    benchmark's optimizer has none."""
    mu, lr = opt["momentum"], opt["learning_rate"]
    worst, rounded = 0.0, True
    for p, (w0, m0), (w1, m1) in zip(step._params, before,
                                     _masters_and_momenta(step)):
        g = p.grad.double()
        lim = 1e-6 * float((mu * m0.abs() + lr * g.abs()).max())
        worst = max(worst, float((m1 - (mu * m0 - lr * g)).abs().max())
                    / max(lim, 1e-30))
        lim = 1e-6 * float(w0.abs().max())
        worst = max(worst, float((w1 - (w0 + m1)).abs().max())
                    / max(lim, 1e-30))
        if p.dtype == torch.bfloat16:
            rounded &= torch.equal(p.detach(), w1.to(torch.bfloat16))
    return {"worst_excess": worst, "bf16_is_master_rounded": bool(rounded),
            "tol": "1e-6 of the largest term"}


def _conv_flops_per_image(net, size=224) -> float:
    """Training FLOPs per image from the model's own convolution and
    classifier shapes: 2 x the multiply-adds of the forward (each
    convolution's output elements times its kernel's in-channels and
    taps, the classifier's in x out), times 3 for the forward and the
    two backward products."""
    from mxnet_tpu_torch.gluon import nn as gnn

    macs = []

    def hook(mod, inp, out):
        k = mod.weight
        macs.append(out.numel() / out.shape[0] * k[0].numel())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, gnn.Conv2D)]
    with torch.no_grad():
        net(torch.zeros(1, 3, size, size, device="cuda",
                        dtype=torch.bfloat16))
    for h in handles:
        h.remove()
    dense = net.output.weight.numel()
    return 3.0 * 2.0 * (sum(macs) + dense)


def _bn_glue_ms(net, x) -> dict:
    """Device ms of the plain BatchNorm forward and backward over one
    step's 53 calls: each BatchNorm's input shape read from one forward
    at the step's batch, and each distinct shape event-timed once (cold
    L2, bf16 input, f32 gamma and beta) and counted as often as the
    model has it. Not a Pallas site; this is its share of the step."""
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.ops import nn as ops_nn

    shapes = {}

    def hook(mod, inp, out):
        key = tuple(inp[0].shape)
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, gnn.BatchNorm)]
    with torch.no_grad():
        net(x)
    for h in handles:
        h.remove()
    flush = _L2Flush()
    total, per = 0.0, {}
    for shape, count in shapes.items():
        c = shape[-1]
        xx = torch.randn(shape, device="cuda",
                         dtype=torch.bfloat16).requires_grad_()
        g = torch.ones(c, device="cuda", requires_grad=True)
        b = torch.zeros(c, device="cuda", requires_grad=True)
        dy = torch.randn_like(xx)

        def fwd_bwd():
            out = ops_nn.batch_norm(xx, g, b, b, g, eps=1e-5,
                                    fix_gamma=False, axis=-1,
                                    training=True)[0]
            torch.autograd.grad(out, (xx, g, b), dy)

        ms = time_ms(fwd_bwd, flush, iters=5, warmup=1)
        per[str(list(shape))] = {"calls": count, "ms_fwd_bwd": ms}
        total += count * ms
        del xx, dy
    torch.cuda.empty_cache()
    return {"ms_per_step": total, "by_shape": per}


def _resnet_kind(name) -> str:
    """Device events of a ResNet step by kind: the SGD sweep, pooling,
    elementwise and reduction glue (BatchNorm, ReLU, the residual adds,
    the loss), copies, and the rest, which is cuDNN's convolutions (and
    its layout transforms) and the classifier's GEMM."""
    low = name.lower()
    if "sgd_kernel" in name:
        return "sgd_sweep"
    if any(k in name for k in _PORT_KERNELS):
        return "port_kernels_other"
    if "memcpy" in low or "memset" in low:
        return "copy_memset"
    if "pool" in low:
        return "pooling"
    if any(k in low for k in ("elementwise", "reduce", "index", "gather",
                              "scatter", "softmax", "fill")):
        return "elementwise_and_reduction_glue"
    return "cudnn_conv_and_gemm"


def phase_resnet_train() -> dict:
    """resnet50_v1(layout="NHWC") at its published widths and depth (1000
    classes, 25.56M parameters), bf16 with f32 BatchNorm, seeded random
    weights, SoftmaxCrossEntropyLoss, SGD at lr 0.1, momentum 0.9,
    multi-precision, as bench.py:221-251 builds it: one (256, 3, 224,
    224) batch of RandomState(0) images with float labels, 3 warm-up and
    20 timed TrainStep calls, cuDNN's autotuner on (torch.backends.cudnn
    .benchmark, restored after). The loss must be finite every step and
    fall strictly over the first three; the second step, the first whose
    momentum is not 0, must follow the update rule by hand
    (_sgd_rule_excess); every running statistic must move, and the
    launches must be exactly one SGD sweep per dtype bucket (2) per step
    and no other training kernel. Past the first steps, at lr 0.1 and
    momentum 0.9 with no warm-up on one repeated batch, the loss
    overshoots and swings, above its first value and back; the JAX
    package's own TrainStep does the same at these settings
    (tests/test_torch_resnet_train.py, run as a script), so where the
    last step lands is not a condition."""
    import gc

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch, timed_steps = 256, 20
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    net = resnet50_v1(layout="NHWC", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda")
                      .manual_seed(SEED))
    step = mx.parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 optimizer_params=dict(RESNET_OPT))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(batch, 3, 224, 224).astype(np.float32)) \
        .to("cuda", torch.bfloat16)
    y = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(np.float32)) \
        .cuda()
    stats0 = _running_stats(net)
    warm = [float(step(x, y)[0])]
    before = _masters_and_momenta(step)
    warm.append(float(step(x, y)[0]))
    rule = _sgd_rule_excess(step, before, RESNET_OPT)
    del before
    warm.append(float(step(x, y)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    timed, enq = [], []
    t1 = time.perf_counter()
    for _ in range(timed_steps):
        timed.append(step(x, y)[0])
        enq.append(time.perf_counter())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = warm + [float(v) for v in timed]
    moved = sum(not torch.equal(v, stats0[k])
                for k, v in _running_stats(net).items())
    per_step = _resnet_per_step(len(step._buckets))
    want = {k: v * timed_steps for k, v in per_step.items()}
    flops = _conv_flops_per_image(net)
    images_s = batch * timed_steps / wall
    out = {"phase": "resnet_train",
           "model": "resnet50_v1(layout='NHWC')",
           "dtype": "bfloat16, f32 BatchNorm, multi-precision sgd",
           "optimizer": RESNET_OPT,
           "params": sum(p.numel() for p in net.parameters()),
           "batch": [batch, 3, 224, 224], "steps": timed_steps,
           "cudnn_benchmark": True,
           "ms_per_step": wall * 1e3 / timed_steps,
           "images_per_s": images_s, "flops_per_image": flops,
           "mfu": flops * images_s / 989e12, "peak_mem_gib": peak,
           "losses": losses, "running_stats_moved": [moved, len(stats0)],
           "update_rule_step2": rule,
           "launches": launches, "launches_expected": want,
           "launches_per_step": per_step,
           "enqueue_ms": [1e3 * (b - a) for a, b in zip([t1] + enq, enq)],
           "buckets": [(len(b.members), str(b.wdtype), b.mp)
                       for b in step._buckets]}
    out["step_breakdown"] = _device_breakdown(lambda: step(x, y), 2,
                                              n_top=16, kind=_resnet_kind)
    out["bn_glue"] = _bn_glue_ms(net, x)
    out["seconds"] = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = bench
    emit(out)
    if not all(np.isfinite(losses)) \
            or not losses[0] > losses[1] > losses[2]:
        fail(f"bf16 ResNet-50 training loss is not finite or did not fall "
             f"over the first three steps: {losses}")
    if rule["worst_excess"] > 1.0 or not rule["bf16_is_master_rounded"]:
        fail(f"ResNet-50's second SGD step broke its update rule: {rule}")
    if moved != len(stats0):
        fail(f"only {moved} of {len(stats0)} BatchNorm running statistics "
             "moved")
    if launches != want or per_step["fused_sgd_sweep"] != 2:
        fail(f"ResNet-50 training launch counts {launches} are not {want} "
             f"({per_step} per step)")
    del step, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------

def main() -> None:
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    picks = phase_kernels()
    phase_reference()
    serving = phase_serving()
    phase_bert_reference()
    serving.update(phase_bert_serving())
    phase_train_reference()
    phase_train_reference(dropout=0.1, attn_dropout=0.1)
    # in turns (0, 0.1, 0.1, 0), so the cost of dropout is read on one
    # card in one process, twice
    train = phase_bert_train()
    train_drop = phase_bert_train(dropout=0.1, attn_dropout=0.1)
    phase_bert_train(dropout=0.1, attn_dropout=0.1)
    phase_bert_train()
    phase_llama_train_reference()
    llama = phase_llama_train()
    phase_resnet_train_reference()
    resnet = phase_resnet_train()
    tpu = "mxnet_tpu/pallas_kernels/"
    csrc = "mxnet_tpu_torch/kernels/csrc/"
    replaces = {
        "fused_rms_norm": ("rms_norm.cu", "fused_layers.py:323"),
        "paged_attention_kernel": ("paged_attention.cu",
                                   "paged_attention.py:150"),
        "fused_layer_norm": ("layer_norm.cu", "fused_layers.py:323"),
        "fused_bias_gelu": ("bias_gelu.cu", "fused_layers.py:533"),
        # one kernel for both forward pallas_call sites (:552 and :590)
        "flash_attention": ("flash_attention.cu", "flash_attention.py:552"),
        "fused_layer_norm_bwd": ("layer_norm.cu", "fused_layers.py:361"),
        "fused_bias_gelu_bwd": ("bias_gelu.cu", "fused_layers.py:539"),
        # one algorithm for the four backward sites (:914, :937, :959,
        # :977)
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "flash_attention.py:914"),
        "fused_adam_sweep": ("fused_optimizer.cu", "fused_optimizer.py:128"),
        # row 9 in RMS mode, reached through _rms_bwd (:479)
        "fused_rms_norm_bwd": ("layer_norm.cu", "fused_layers.py:361"),
        # row 12 for the adamw family: its scan and its sweep
        "fused_adamw_sweep": ("fused_optimizer.cu",
                              "fused_optimizer.py:128"),
        # row 12 for the sgd family
        "fused_sgd_sweep": ("fused_optimizer.cu", "fused_optimizer.py:128"),
        # the dropout modes of rows 1', 9, 3-4 and 5-8
        "fused_layer_norm[dropout]": ("layer_norm.cu", "fused_layers.py:323"),
        "fused_layer_norm_bwd[dropout]": ("layer_norm.cu",
                                          "fused_layers.py:361"),
        "flash_attention[dropout]": ("flash_attention.cu",
                                     "flash_attention.py:552"),
        "flash_attention_bwd[dropout]": ("flash_attention_bwd.cu",
                                         "flash_attention.py:914"),
        # not a Pallas site: dropout_op's hash branch, which XLA fuses
        "hash_dropout": ("dropout.cu", None),
    }
    also = {"flash_attention": ["flash_attention.py:590"],
            "flash_attention_bwd": ["flash_attention.py:937",
                                    "flash_attention.py:959",
                                    "flash_attention.py:977"],
            "flash_attention[dropout]": ["flash_attention.py:590"],
            "flash_attention_bwd[dropout]": ["flash_attention.py:937",
                                             "flash_attention.py:959",
                                             "flash_attention.py:977"]}
    notes = {
        "hash_dropout": "not a Pallas site: dropout_op's hash branch, "
                        "which XLA fuses into its neighbours",
        "fused_rms_norm_bwd": "_norm_bwd_pallas in RMS mode, reached "
                              "through _rms_bwd (fused_layers.py:479)",
        "fused_adamw_sweep": "the adamw family: one overflow scan and one "
                             "sweep per bucket; ms and bound_ms cover both "
                             "launches",
        "fused_sgd_sweep": "the sgd family: one sweep per dtype bucket, two "
                           "per ResNet-50 step (bf16-mp and f32); ms and "
                           "bound_ms cover both buckets"}
    kernels = []
    for name, (src, site) in replaces.items():
        r = picks[name]
        by_path = {}
        if name in serving:
            by_path["serving"] = serving[name]
        if name in train and train[name]:
            by_path["bert_train"] = train[name]
        if train_drop.get(name):
            by_path["bert_train_dropout"] = train_drop[name]
        if llama.get(name):
            by_path["llama_train"] = llama[name]
        if name == "fused_adamw_sweep":
            by_path["llama_train[scan]"] = llama[name + "[scan]"]
        if resnet.get(name):
            by_path["resnet_train"] = resnet[name]
        launches = next(iter(by_path.values()))
        if name == "hash_dropout":
            # one kernel for the op's forward and backward wrappers
            by_path["bert_train_dropout"] = {
                "hash_dropout": train_drop["hash_dropout"],
                "hash_dropout_bwd": train_drop["hash_dropout_bwd"]}
            launches = sum(by_path["bert_train_dropout"].values())
        rec = {"name": name, "route": "cuda", "source": csrc + src,
               "replaces": tpu + site if site else
               "mxnet_tpu/ops/nn.py:1079", "launches": launches,
               "launches_by_path": by_path,
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "shape": r["shape"], "dtype": r["dtype"]}
        if name in also:
            rec["also_replaces"] = [tpu + x for x in also[name]]
        if name in notes:
            rec["note"] = notes[name]
        kernels.append(rec)
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
