"""Where the flash forward's warpgroup route spends its time on the card.

    python -m mxnet_tpu_torch.tools.flash_fwd_ablation

Builds variants of ``kernels/csrc/flash_attention.cu``, each with one
part of the work taken out by a text edit of a copy of ``csrc/`` under
``build/ablation/fwd/`` (git-ignored), all ``nvcc`` processes at once, and
times each beside the kernel as committed at BERT-base's fused-QKV views
(32, 512, 12, 64) and proxy1b's causal (8, 2048, 16, 128) heads, bf16
"blhd": the device time of one call, the median over 20 calls, each
after an L2 flush and bracketed by CUDA events, all queued behind a
sleep kernel so that the wrapper's host time is not timed, after two
seconds of GEMMs that ramp the clocks up. A variant's
output is wrong by design; only the committed kernel is held against
the plain version. Prints one JSON line per variant and shape, then a
summary line with the card's name and power limit. Needs one CUDA card
and ``nvcc``; exits non-zero without them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..kernels import _build
from ..kernels.flash import flash_attention_fwd, flash_attention_reference
from .flash_bwd_ablation import _build_variants

_SRC = "flash_attention.cu"
# each variant: (what it takes out, [(text, replacement), ...]); every
# text must occur in the committed source
VARIANTS = {
    "committed": ("nothing", []),
    "no_softmax": ("the online softmax: mask, max, exp2, row sums, alpha "
                   "(P is the raw score)", [
                       ("softmax_tile<Drop>(s, m, l, alpha, p,",
                        "if (p.b < 0) softmax_tile<Drop>(s, m, l, alpha, "
                        "p,")]),
    "exact_exp2f": ("ex2.approx: P by exp2f, whose exact path branches "
                    "per element", [
                        ("x = mxhop::fexp2(fmaf(x, p.scale2, -mu));",
                         "x = exp2f(fmaf(x, p.scale2, -mu));")]),
    "no_mask": ("the mask of the tiles across the diagonal or the ragged "
                "edge", [("  if (mask) {", "  if (p.b < 0 && mask) {")]),
    "no_score_mma": ("the shared-memory wgmma of S = Q . K^T", [
        ("issue_scores<D>(s, qs, 64 * cw,",
         "if (p.b < 0) issue_scores<D>(s, qs, 64 * cw,")]),
    "no_pv_mma": ("the register-A wgmma of O += P . V", [
        ("issue_pv<D>(o, a,", "if (p.b < 0) issue_pv<D>(o, a,")]),
    "no_tile_loads": ("the copies of every K and V tile past the ring's "
                      "first fill (the barriers still turn, so the "
                      "consumers never wait for data)", [
                          ("mxhop::load_tile_async<kWgTile, D, 128>(st",
                           "if (it < S::kStages) "
                           "mxhop::load_tile_async<kWgTile, D, 128>(st")]),
    "no_overlap": ("the overlap of tile j + 1's softmax with tile j's "
                   "P . V (the softmax waits for both products)", [
                       ("mxhop::wgmma_wait<1>();",
                        "mxhop::wgmma_wait<0>();")]),
    "no_pingpong": ("the ping-pong turns of the two consumer warpgroups", [
        ("  mxhop::named_sync(2 + cw, 256);", ""),
        ("  mxhop::named_arrive(3 - cw, 256);", "")]),
    "static_schedule": ("the dynamic hand-out of work items (item "
                        "blockIdx.x + j * gridDim.x instead)", [
                            ("gridDim.x + atomicAdd(next_item, 1);",
                             "blockIdx.x + (j + 1) * gridDim.x;")]),
    "no_head_groups": ("the grouping of heads by L2 size (one group: every "
                       "head's last query block first)", [
                           ("kL2GroupBytes / head_bytes",
                            "(1ll << 50) / head_bytes")]),
    "no_proxy_fence": ("the consumers' proxy fence after each tile wait "
                       "(unsafe: timing only)", [
                           ("hopper.cuh", "  mbar_wait(bar, parity);\n"
                            "  fence_async_smem();",
                            "  mbar_wait(bar, parity);")]),
}
SHAPES = {"bert_views": (32, 12, 512, 64, False, True),
          "proxy1b_causal": (8, 16, 2048, 128, True, False)}


def _inputs(b, h, l, d, views, gen):
    if views:
        qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen)
        return tuple(t.view(b, l, h, d)
                     for t in qkv.to(torch.bfloat16).split(h * d, dim=-1))
    return tuple(torch.randn(b, l, h, d, device="cuda", generator=gen)
                 .to(torch.bfloat16) for _ in range(3))


def _queued_ms(fn, flush, iters=20, warmup=3, sleep_cycles=int(2e8)):
    """Median device ms of ``fn`` over ``iters`` calls, each after an L2
    flush and bracketed by CUDA events, all queued behind a sleep kernel
    of ``sleep_cycles``, so the pairs time the card's work only."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    for s, e in pairs:
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _warm_card(seconds=2.0) -> None:
    """bf16 GEMMs for ``seconds``, so the clocks have ramped up before the
    first variant is timed."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ablation: needs a CUDA card")
    libs = _build_variants(_build.REPO_ROOT / "build" / "ablation" / "fwd",
                           _SRC, VARIANTS)
    _warm_card()
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {key: (_inputs(b, h, l, d, views, gen),
                   {"causal": causal, "layout": "blhd"})
             for key, (b, h, l, d, causal, views) in SHAPES.items()}
    summary = {}
    for name, lib in libs.items():
        _build._libs[_SRC] = lib
        for key, ((q, k, v), kw) in cases.items():
            def call():
                return flash_attention_fwd(q, k, v, **kw)
            rec = {"variant": name, "takes_out": VARIANTS[name][0],
                   "shape": key, "device_ms": _queued_ms(call, flush)}
            if name == "committed":
                out, lse = call()
                ref, rlse = flash_attention_reference(q, k, v, **kw)
                rec["max_abs_err"] = float((out.float() - ref.float())
                                           .abs().max())
                rec["lse_max_abs_err"] = float((lse - rlse).abs().max())
            summary.setdefault(key, {})[name] = rec["device_ms"]
            print(json.dumps(rec), flush=True)
    _build._libs.pop(_SRC, None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(json.dumps({"card": smi, "device_ms": summary}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
