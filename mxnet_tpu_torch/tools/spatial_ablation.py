"""Where the roi_align and correlation kernels spend their time, measured
on the card.

    python -m mxnet_tpu_torch.tools.spatial_ablation

Builds variants of ``kernels/csrc/correlation.cu`` and
``kernels/csrc/roi_align.cu``, each with one part of the design taken
out or changed (text edits of the committed kernel, in a copy of
``csrc/`` under ``build/ablation/spatial/``, git-ignored; all ``nvcc``
processes at once), and times each beside the kernel as committed at
the shapes of ``chip_smoke.py``'s spatial phase: FlowNetC's cost volume
(``_flownet_inputs``, (8, 256, 48, 64), 441 displacements) forward and
backward, and Faster R-CNN's RoI head (``_frcnn_inputs``, 256 RoIs of a
(2, 1024, 38, 63) map, 14 x 14, sr 2) forward and backward. A time is
the device time of one call: the median over 20 calls, each after an L2
flush and bracketed by CUDA events, all queued behind a sleep kernel,
after two seconds of GEMMs that ramp the clocks up. Only the committed
kernels compute the function (the kernels phase holds them against their
plain versions); a variant that leaves work out is timed, not checked.
Prints one JSON line per variant and case, then a summary line with the
card's name and power limit. Needs one CUDA card and ``nvcc``; exits
non-zero without them.
"""
from __future__ import annotations

import json
import subprocess

import torch

from ..kernels import _build
from ..kernels.correlation import correlation, correlation_bwd
from ..kernels.roi_align import roi_align, roi_align_bwd
from .flash_bwd_ablation import _build_variants
from .flash_fwd_ablation import _queued_ms, _warm_card
from .nms_ab import load_smoke

_CORR = "correlation.cu"
_ROI = "roi_align.cu"
_CORR_COMPUTE = "    if (live) {\n      const float* sa = smem"
CORR_VARIANTS = {
    "committed": ("nothing", []),
    "no_sum": ("the forward's products and sums (staging and the store "
               "stay)", [(_CORR_COMPUTE,
                          "    if (false) {\n      const float* sa = smem")]),
    "no_stage": ("the forward's copies into shared memory (the sums read "
                 "what is there)",
                 [("    for (int cc = 0; cc < nc; ++cc) {\n"
                   "      const T* pa = a_img",
                   "    for (int cc = 0; cc < 0; ++cc) {\n"
                   "      const T* pa = a_img")]),
    "smem_32k": ("a 32 KB staging budget (two buffers of 4 channels)",
                 [("constexpr int kSmemBudget = 64 * 1024;",
                   "constexpr int kSmemBudget = 32 * 1024;")]),
    "smem_128k": ("a 128 KB staging budget (two buffers of 18 channels, "
                  "one CTA an SM)",
                  [("constexpr int kSmemBudget = 64 * 1024;",
                    "constexpr int kSmemBudget = 128 * 1024;")]),
    "bwd_no_gather": ("the backward's loads of the other map (G kept)",
                      [("        const float o = in ? mxk::to_f(other[cc * "
                        "plane + q]) : 0.f;",
                        "        const float o = in ? 1.f : 0.f;")]),
    "bwd_no_g": ("the backward's head-gradient sums (G = 1)",
                 [("      const float G = window_grad(",
                   "      const float G = 1.f + 0.f * window_grad(")]),
}
ROI_VARIANTS = {
    "committed": ("nothing", []),
    "bwd_no_atomics": ("the backward's atomic adds into d data (one plain "
                       "store a bin instead)",
                       [("            atomicAdd(row + cols[j], gr * "
                         "cw[j]);",
                         "            if (gr == 12345.f) row[cols[j]] = "
                         "gr * cw[j];")]),
    "fwd_one_sample": ("the forward's samples but the first (one blend a "
                       "bin)", [("            sum = __fadd_rn(sum, blend("
                                 "img, s.w, ay[iy], ax[ix]));",
                                 "            if (iy + ix == 0) sum = "
                                 "__fadd_rn(sum, blend(img, s.w, ay[iy], "
                                 "ax[ix]));")]),
    "chunk_4": ("4 channels a CTA (4x the CTAs)",
                [("constexpr int kChunk = 16;", "constexpr int kChunk = 4;")]),
    "chunk_64": ("64 channels a CTA",
                 [("constexpr int kChunk = 16;",
                   "constexpr int kChunk = 64;")]),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("spatial_ablation: needs a CUDA card")
    root = _build.REPO_ROOT / "build" / "ablation" / "spatial"
    libs = {_CORR: _build_variants(root / "corr", _CORR, CORR_VARIANTS),
            _ROI: _build_variants(root / "roi", _ROI, ROI_VARIANTS)}
    smoke = load_smoke()
    a, b = smoke._flownet_inputs(smoke.FLOWNETC["batch"], smoke.SEED + 32)
    kw = smoke._corr_kw()
    args = [kw[k] for k in ("kernel_size", "max_displacement", "stride1",
                            "stride2", "pad_size")]
    g = torch.ones_like(correlation(a, b, **kw))
    f = smoke.FRCNN
    data, rois, head = smoke._frcnn_inputs(f["rois"], smoke.SEED + 31)
    rkw = dict(pooled_size=f["pooled_size"],
               spatial_scale=f["spatial_scale"],
               sample_ratio=f["sample_ratio"], aligned=False)
    cases = {
        _CORR: {"correlation": lambda: correlation(a, b, **kw),
                "correlation_bwd": lambda: correlation_bwd(g, a, b, *args)},
        _ROI: {"roi_align": lambda: roi_align(data, rois, **rkw),
               "roi_align_bwd": lambda: roi_align_bwd(
                   head, data, rois, f["pooled_size"], f["spatial_scale"],
                   f["sample_ratio"])}}
    _warm_card()
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    summary = {}
    for src, variants in libs.items():
        descr = CORR_VARIANTS if src == _CORR else ROI_VARIANTS
        # the committed kernel first and again last, so that a drift of
        # the card over the call shows
        order = list(variants.items()) + [("committed_last",
                                           variants["committed"])]
        for name, lib in order:
            _build._libs[src] = lib
            for case, call in cases[src].items():
                rec = {"variant": name, "source": src, "case": case,
                       "takes_out": descr.get(name, ("nothing",))[0],
                       "device_ms": _queued_ms(call, flush)}
                print(json.dumps(rec), flush=True)
                summary[f"{name}[{case}]"] = rec["device_ms"]
        _build._libs.pop(src, None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "device_ms": summary}), flush=True)


if __name__ == "__main__":
    main()
