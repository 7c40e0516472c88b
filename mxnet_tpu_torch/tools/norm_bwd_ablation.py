"""What held the norm backward back, measured on the card.

    python -m mxnet_tpu_torch.tools.norm_bwd_ablation

Builds variants of ``kernels/csrc/layer_norm.cu``, each with one piece of
the backward's design turned back to the old design's, or one of its
own parts changed (text edits of the committed kernel, in a copy of
``csrc/`` under ``build/ablation/norm_bwd/``, git-ignored; all ``nvcc``
processes at once), and times each beside the kernel as committed: BERT-base's
LayerNorm backward at (16384, 768) bf16 with the residual, without it,
and with the residual and dropout 0.1, and proxy1b's RMSNorm backward at
(16384, 2048) bf16. A time is the device time of one call: the median
over 20 calls, each after an L2 flush and bracketed by CUDA events, all
queued behind a sleep kernel so that the wrapper's host time is not
timed, after two seconds of GEMMs that ramp the clocks up. Only the
committed kernel is held against the plain version (the first five
variants compute the same function; ``torch_final_sum`` adds the
partial rows in torch, two more launches, as the old wrapper did; the
last five vary the committed design's own parts, and ``no_final_sum``
and ``no_rows`` leave work out). Prints one JSON line per
variant and case, then a summary line with the card's name and power
limit. Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from ..kernels import _build
from ..kernels import fused_layers as fl
from .flash_bwd_ablation import _build_variants
from .flash_fwd_ablation import _queued_ms, _warm_card

_SRC = "layer_norm.cu"
_STAGE_BYTES = "p.stage_bytes = d * (sx * (has_res ? 2 : 1) + sy);"
_STAGES = "p.stages = (kBwdSmemBudget - gam) / (p.gpc * p.stage_bytes);"
_PROLOGUE = "for (int k = 0; k < p.stages && k < n_rows; ++k) issue(k);"
_REFILL = "if (gt == 0 && k + p.stages < n_rows) issue(k + p.stages);"
_FROM_STAGE = """    mxhop::mbar_wait(bars + stage, phase);
    const unsigned char* st = ring + stage * p.stage_bytes;
    const TX* xr = reinterpret_cast<const TX*>(st);
    const TX* rr =
        res != nullptr ? reinterpret_cast<const TX*>(st + x_bytes) : nullptr;
    const TY* yr = reinterpret_cast<const TY*>(st + y_off);
"""
_FROM_MEMORY = """    const size_t off = static_cast<size_t>(r) * d;
    const TX* xr = x + off;
    const TX* rr = res != nullptr ? res + off : nullptr;
    const TY* yr = dy + off;
"""
_FINAL = "  final_sums<4, TW>(parts, A, d, counter, dgamma, dbeta);"
_WPR = "  p.wpr = 1;\n"
_GPC = "p.gpc = kBwdWarps / p.wpr;"
_PER_SM = "if (per_sm < 1) per_sm = 1;"
_ROWS = "for (int k = 0; k < n_rows; ++k, r += p.gpc) {"
# the old design's pieces, as edits of the committed kernel
_NO_RING = [(_STAGE_BYTES, "p.stage_bytes = 0;"), (_STAGES, "p.stages = 1;"),
            (_PROLOGUE, ""), (_REFILL, ""), (_FROM_STAGE, _FROM_MEMORY)]
_NO_FINAL_SUM = [(_FINAL, "")]
_ONE_ROW_PER_CTA = [(_WPR, "  p.wpr = 4;\n"), (_GPC, "p.gpc = 1;")]
_OLD_GRID = [(_PER_SM, "per_sm = 8;")]
# each variant: (what it turns back, [(text, replacement), ...]); every
# text must occur in the committed source
VARIANTS = {
    "committed": ("nothing", []),
    "no_ring": ("the bulk-copy ring: each pass loads the row from device "
                "memory (the second from L1/L2)", _NO_RING),
    "torch_final_sum": ("the in-kernel final sum: the CTAs' partial rows "
                        "are added up and cast by torch, two more "
                        "launches", _NO_FINAL_SUM),
    "one_cta_per_row": ("one row per warp: a CTA of 4 warps takes a row at "
                        "a time, its reductions across warps",
                        _ONE_ROW_PER_CTA),
    "old_grid": ("the persistent grid: 8 CTAs per SM (the old "
                 "_BWD_CTAS_PER_SM), so 1056 CTAs in waves, each with a "
                 "partial row", _OLD_GRID),
    "old_design": ("all four at once",
                   _NO_RING + _NO_FINAL_SUM + _ONE_ROW_PER_CTA + _OLD_GRID),
    # the committed design's own parts
    "no_final_sum": ("the final sum itself: the partial rows are left "
                     "unsummed (what the in-kernel sum costs)",
                     _NO_FINAL_SUM),
    "reducers_8": ("32 reducing CTAs: 8 share the final sum", [
        ("constexpr int kBwdReducers = 32;",
         "constexpr int kBwdReducers = 8;")]),
    "warps_8": ("16 warps per CTA: 8 (half the rows in flight)", [
        ("constexpr int kBwdWarps = 16;", "constexpr int kBwdWarps = 8;")]),
    "one_stage": ("the ring's depth: one stage, the next row's copy "
                  "issued only when this row is done", [
                      ("constexpr int kBwdMaxStages = 4;",
                       "constexpr int kBwdMaxStages = 1;")]),
    "no_rows": ("every row (no copies, no row work): what the launch, "
                "gamma, the partial rows and the final sum cost", [
                    (_ROWS, "for (int k = 0; k < 0; ++k, r += p.gpc) {"),
                    (_PROLOGUE, "")]),
}
BF16 = torch.bfloat16


def _cases(gen):
    """name: (the wrapper's call, its plain version's) at the main
    path's shapes."""
    def randn(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, device="cuda",
                                            generator=gen)).to(BF16)

    rows, d = 32 * 512, 768
    x, r = randn(rows, d, shift=2.0), randn(rows, d)
    g, b = randn(d, scale=0.1, shift=1.0), randn(d, scale=0.1)
    dy = randn(rows, d)
    out = {}
    for name, res, p, seed in (("bert_residual", r, 0.0, None),
                               ("bert_no_residual", None, 0.0, None),
                               ("bert_residual_dropout", r, 0.1, 0xD0D0)):
        _, mean, rstd = fl.fused_layer_norm(x, g, b, res, dropout=p,
                                            seed=seed, return_stats=True)
        out[name] = (
            lambda res=res, p=p, seed=seed, mean=mean, rstd=rstd:
            fl.fused_layer_norm_bwd(x, g, mean, rstd, dy, res, p, seed),
            lambda res=res, p=p, seed=seed, mean=mean, rstd=rstd:
            fl.fused_layer_norm_bwd_reference(x, g, mean, rstd, dy, res, p,
                                              seed))
    rows, d = 8 * 2048, 2048
    x2, w2, dy2 = randn(rows, d, scale=1.5), randn(d, scale=0.1, shift=1.0), \
        randn(rows, d)
    _, rstd2 = fl._rms_norm_fwd(x2, w2, 1e-5, True)
    out["proxy1b_rms"] = (
        lambda: fl.fused_rms_norm_bwd(x2, w2, rstd2, dy2),
        lambda: fl.fused_rms_norm_bwd_reference(x2, w2, rstd2, dy2))
    return out


def _with_torch_sum(call):
    """``call`` followed by torch's sum over the partial rows it wrote and
    the cast to bf16, the old wrapper's two launches."""
    seen = {}
    scratch = fl._norm_bwd_scratch

    def spy(*args):
        got = scratch(*args)
        seen["parts"] = got[1]
        return got

    def run():
        fl._norm_bwd_scratch = spy
        try:
            call()
        finally:
            fl._norm_bwd_scratch = scratch
        return seen["parts"].sum(dim=1).to(BF16)
    return run


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("norm_bwd_ablation: needs a CUDA card")
    libs = _build_variants(
        _build.REPO_ROOT / "build" / "ablation" / "norm_bwd", _SRC, VARIANTS)
    _warm_card()
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    cases = _cases(torch.Generator(device="cuda").manual_seed(0))
    # right after the GEMMs the first memory-bound timing reads up to 2x
    # high: half a second of the first case, untimed, before any is timed
    first = next(iter(cases.values()))[0]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        flush.sum()
        first()
    torch.cuda.synchronize()
    summary = {}
    for name, lib in libs.items():
        _build._libs[_SRC] = lib
        fl._bwd_blocks.cache_clear()     # a variant may choose another grid
        for key, (call, plain) in cases.items():
            timed = _with_torch_sum(call) if name == "torch_final_sum" \
                else call
            rec = {"variant": name, "turns_back": VARIANTS[name][0],
                   "case": key, "device_ms": _queued_ms(timed, flush)}
            if name == "committed":
                got, want = call(), plain()
                rec["max_err_over_max_ref"] = max(
                    float((a.float() - w.float()).abs().max())
                    / max(float(w.float().abs().max()), 1e-30)
                    for a, w in zip(got, want))
            summary.setdefault(key, {})[name] = rec["device_ms"]
            print(json.dumps(rec), flush=True)
    _build._libs.pop(_SRC, None)
    fl._bwd_blocks.cache_clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(json.dumps({"card": smi, "device_ms": summary}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
