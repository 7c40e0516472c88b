#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) end to end on one card.

    python3 chip_smoke.py

Needs one CUDA card and the checkout around this file; exits non-zero
without a result line otherwise. It imports nothing of JAX or of the JAX
package. Phases, each printing JSON lines and failing loudly:

1. device  — the card's name and power limit, as nvidia-smi gives them;
2. build   — nvcc builds every kernel of the path from the checkout's
             sources (into build/kernels/, listed in .gitignore);
3. kernels — each kernel against its plain PyTorch version at the
             serving path's shapes, bf16 and f32, with its stated
             tolerance; kernel, plain and library-call times from CUDA
             events (cold L2), and the least time the card could take
             (bound_ms) from this run's bytes and operations;
4. reference — the decode path at Llama-3-8B widths, depth cut to 2
             layers, in f32: each stream's last decode-step logits
             against forward_full over the same tokens, to f32 noise;
5. serving — Llama-3-8B at full width (32 layers, bf16, seeded random
             weights) behind serving.Server: 8 concurrent
             submit_generate calls (prompts of 100-500 tokens, 32 new
             tokens each); tokens/s, TTFT, per-token latency, the
             kernels' launch counts over this phase, and each stream's
             last decode-step logits against forward_full over the same
             tokens;
6. summary — one {"kernels": [...]} line.

The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
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


def rms_case(rows, d, dtype, flush, gen) -> dict:
    import torch.nn.functional as F

    from mxnet_tpu_torch.kernels import (fused_rms_norm,
                                         fused_rms_norm_reference)

    x = torch.randn(rows, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    out = fused_rms_norm(x, w, eps=eps)
    torch.cuda.synchronize()
    ref = fused_rms_norm_reference(x, w, eps=eps)
    err, ok = within(out, ref, *RMS_TOL[dtype])
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = rows * d * size * 2 + d * size
    b_ms, b_by = bound(n_bytes, 4.0 * rows * d, torch.float32)
    rec = {"phase": "kernels", "kernel": "fused_rms_norm",
           "shape": [rows, d], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err, "rtol_atol": list(RMS_TOL[dtype]), "ok": ok,
           "ms": time_ms(lambda: fused_rms_norm(x, w, eps=eps), flush),
           "plain_ms": time_ms(lambda: fused_rms_norm_reference(x, w,
                                                                 eps=eps),
                               flush),
           "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, eps),
                                 flush),
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
    bad = [r for r in recs if not r["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    del flush
    torch.cuda.empty_cache()
    # the decode-step shapes of the serving path stand for each kernel in
    # the summary: RMS (8, 4096) bf16, paged B = 8 bf16
    pick = {}
    for r in recs:
        if r["dtype"] != "bfloat16":
            continue
        if r["kernel"] == "fused_rms_norm" and r["shape"] == [8, 4096]:
            pick["fused_rms_norm"] = r
        if r["kernel"] == "paged_attention_kernel" and r["shape"]["B"] == 8:
            pick["paged_attention_kernel"] = r
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


def _decode_breakdown(engine, rs, vocab, batch=8, steps=8) -> dict:
    """Where a (batch, 1) decode step's time goes: host wall time per
    step (synchronised, unprofiled) against the device time
    torch.profiler records over as many further steps, and the device
    events that take most of it. Rows hold 300-token prompts, as in the
    serving phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    owners = [object() for _ in range(batch)]
    width = engine.pool.pages_for(768)
    table = np.zeros((batch, width), np.int32)
    tokens = rs.randint(0, vocab, size=(batch, 512)).astype(np.int32)
    lengths = np.full((batch,), 300, np.int32)
    try:
        for i, o in enumerate(owners):
            table[i, :engine.pool.pages_for(300 + 2 * steps + 2)] = \
                engine.pool.alloc(o, 300 + 2 * steps + 2)
        nxt = np.argmax(engine.prefill(tokens, lengths, table), -1)
        for _ in range(2):                                   # warm
            lengths = lengths + 1
            nxt = np.argmax(engine.decode_step(nxt, lengths, table), -1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()                    # host clock, unprofiled
        for _ in range(steps):
            lengths = lengths + 1
            nxt = np.argmax(engine.decode_step(nxt, lengths, table), -1)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                lengths = lengths + 1
                nxt = np.argmax(engine.decode_step(nxt, lengths, table), -1)
            torch.cuda.synchronize()
    finally:
        for o in owners:
            engine.pool.free(o)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): a CPU op's device time
    # repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"batch": batch, "context": 300, "host_ms_per_step": host_ms,
            "device_ms_per_step": device_ms,
            "device_idle_share": 1 - device_ms / host_ms,
            "top_device_ms_per_step": {e.key[:60]: dev_us(e) / 1e3 / steps
                                       for e in top}}


# ---------------------------------------------------------------------------

def main() -> None:
    phase_device()
    phase_build()
    picks = phase_kernels()
    phase_reference()
    launches = phase_serving()
    replaces = {
        "fused_rms_norm": ("mxnet_tpu_torch/kernels/csrc/rms_norm.cu",
                           "mxnet_tpu/pallas_kernels/fused_layers.py:323"),
        "paged_attention_kernel": (
            "mxnet_tpu_torch/kernels/csrc/paged_attention.cu",
            "mxnet_tpu/pallas_kernels/paged_attention.py:150"),
    }
    kernels = []
    for name, (src, tpu) in replaces.items():
        r = picks[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "dtype": r["dtype"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
