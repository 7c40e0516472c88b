"""Where the box_nms kernels spend their time, measured on the card.

    python -m mxnet_tpu_torch.tools.nms_ablation

Builds variants of ``kernels/csrc/box_nms.cu``, each with one part of
the design taken out (text edits of the committed kernel, in a copy of
``csrc/`` under ``build/ablation/nms/``, git-ignored; all ``nvcc``
processes at once), and times each beside the kernel as committed on SSD
detect's rows (``chip_smoke.py``'s ``nms_case``'s, loaded through
``nms_ab.load_smoke``) at ``topk`` 400 (the shared route, one launch) and at
the op's default ``topk=-1`` (the global route, two). A time is the
device time of one call: the median over 20 calls, each after an L2
flush and bracketed by CUDA events, all queued behind a sleep kernel,
after two seconds of GEMMs that ramp the clocks up. Only the committed
kernel computes the function (and is held against the plain version);
a variant that leaves work out is timed, not checked. Prints one JSON
line per variant and case, then a summary line with the card's name and
power limit. Needs one CUDA card and ``nvcc``; exits non-zero without
them.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..kernels import _build
from ..kernels.box_nms import box_nms_sorted, box_nms_sorted_reference
from .flash_bwd_ablation import _build_variants
from .flash_fwd_ablation import _queued_ms, _warm_card
from .nms_ab import load_smoke

_SRC = "box_nms.cu"
_ROUNDS = """    while (open) {
      const u64 live = open | keep;
      const u64 kb = ballot64(!(slo & live), !(shi & live)) & open;
      keep |= kb;
      open &= ~(kb | ballot64(slo & keep, shi & keep));
    }"""
_SWEEP_TOP = """  const int lane = threadIdx.x & 31;
  u64 rem = 0ull;"""
_LIVE = "const bool live = f == 3 && own_valid;"
VARIANTS = {
    "committed": ("nothing", []),
    "no_rounds": ("the rounds that settle a word's candidates: every "
                  "candidate kept", [(_ROUNDS, "    keep = open;")]),
    "no_update": ("the ORs of the kept rows' words into later words",
                  [("    if (keep) {", "    if (false) {")]),
    "no_sweep": ("the sweep: every valid row kept",
                 [(_SWEEP_TOP, "  for (int w = threadIdx.x & 31; w < words;"
                   " w += 32)\n    kept[w] = valid[w];\n  return;\n"
                   + _SWEEP_TOP)]),
    "no_iou_no_sweep": ("the IoUs and the sweep",
                        [(_LIVE, "const bool live = false;"),
                         (_SWEEP_TOP, "  for (int w = threadIdx.x & 31; "
                          "w < words; w += 32)\n    kept[w] = valid[w];\n"
                          "  return;\n" + _SWEEP_TOP)]),
    "no_rows": ("the m sorted rows' output",
                [("  write_rows(base, ob, kept, m, k, cs, in_center, "
                  "out_center);\n  if (ranks == 1)",
                  "  if (ranks == 1)")]),
    "no_tail": ("the -1 rows m..n_out-1",
                [("    fill_neg(tail, n_tail, rank - 1, ranks - 1);\n", "")]),
    "empty": ("everything: the cluster kernel returns at once",
              [("  extern __shared__ __align__(16) u64 smem[];\n"
                "  cg::cluster_group cluster = cg::this_cluster();",
                "  extern __shared__ __align__(16) u64 smem[];\n"
                "  if (m > 0) return;\n"
                "  cg::cluster_group cluster = cg::this_cluster();")]),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("nms_ablation: needs a CUDA card")
    libs = _build_variants(_build.REPO_ROOT / "build" / "ablation" / "nms",
                           _SRC, VARIANTS)
    smoke = load_smoke()
    rows, kw = smoke._nms_detect_rows(), smoke.NMS_DETECT_KW
    n = rows.shape[1]
    cases = {topk: smoke._sorted_nms_rows(rows, topk)[0]
             for topk in (400, -1)}
    _warm_card()
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    summary, exact = {}, False
    # the committed kernel first and again last, so that a drift of the
    # card over the call shows
    order = list(libs.items()) + [("committed_last", libs["committed"])]
    for name, lib in order:
        _build._libs[_SRC] = lib
        for topk, srt in cases.items():
            def call():
                return box_nms_sorted(srt, n, **kw)
            rec = {"variant": name,
                   "takes_out": VARIANTS.get(name, ("nothing",))[0],
                   "topk": topk, "device_ms": _queued_ms(call, flush)}
            if name == "committed":
                got = call()
                want = torch.cat([box_nms_sorted_reference(
                    srt[i:i + 4], n, **kw) for i in range(0, len(srt), 4)])
                rec["bit_identical"] = bool(
                    torch.equal(got.isnan(), want.isnan())
                    and torch.equal(got.nan_to_num(7.0).view(torch.int32),
                                    want.nan_to_num(7.0).view(torch.int32)))
                exact = rec["bit_identical"] and (exact or topk == 400)
            print(json.dumps(rec), flush=True)
            summary[f"{name}[topk={topk}]"] = rec["device_ms"]
    _build._libs.pop(_SRC, None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "device_ms": summary}), flush=True)
    sys.exit(0 if exact else 1)


if __name__ == "__main__":
    main()
