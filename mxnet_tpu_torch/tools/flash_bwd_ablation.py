"""Where the flash backward's warpgroup route spends its time on the card.

    python -m mxnet_tpu_torch.tools.flash_bwd_ablation

Builds variants of ``kernels/csrc/flash_attention_bwd.cu``, each with one
part of the work taken out by a text edit of a copy of ``csrc/`` under
``build/ablation/bwd/`` (git-ignored), all ``nvcc`` processes at once, and
times each beside the kernel as committed at BERT-base's fused-QKV views
(32, 512, 12, 64) and proxy1b's causal (8, 2048, 16, 128) heads, bf16
"blhd": the median of 20 calls, each after an L2 flush, bracketed by
CUDA events (a call takes a third of a millisecond or more, so the
wrapper's host time is a few percent of it). A variant's gradients are
wrong by design; only the committed kernel is held against the plain
version. Prints one JSON line per variant and shape, then a summary
line. Needs one CUDA card and ``nvcc``; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import _build
from ..kernels.flash import (flash_attention_bwd,
                             flash_attention_bwd_reference,
                             flash_attention_fwd)

_SRC = "flash_attention_bwd.cu"
# each variant: (what it takes out, [(text, replacement), ...]); every
# text must occur in the committed source
VARIANTS = {
    "committed": ("nothing", []),
    "exact_exp2f": ("ex2.approx: P by exp2f, whose exact path branches "
                    "per element", [
                        ("fexp2(sp[j] * p.scale2 - lse_q",
                         "exp2f(sp[j] * p.scale2 - lse_q"),
                        ("fexp2(sp[j] * p.scale2 - lse_r",
                         "exp2f(sp[j] * p.scale2 - lse_r")]),
    "no_softmax_math": ("P and dS arithmetic (P = S, dS = dP)", [
        ("sp[j] = fexp2(sp[j] * p.scale2 - lse_q[2 * (j >> 2) + (j & 1)]);",
         "sp[j] = sp[j];"),
        ("sp[j] = fexp2(sp[j] * p.scale2 - lse_r[(j >> 1) & 1]);",
         "sp[j] = sp[j];"),
        ("dp[j] = sp[j] * (dp[j] - delta) * p.scale;", "dp[j] = dp[j];"),
        ("dp[j] = sp[j] * (d_p - delta_r[r]) * p.scale;", "dp[j] = d_p;")]),
    "first_tile_only": ("the math of every streamed tile but the first "
                        "(loads, barriers, prologue and epilogue stay)", [
                            ("const bool skip = wk0 >= p.lk ||",
                             "const bool skip = i > 0 || wk0 >= p.lk ||"),
                            ("const bool skip = wq0 >= p.lq ||",
                             "const bool skip = i > 0 || wq0 >= p.lq ||")]),
    "no_gradient_mma": ("the register-A wgmma of dV, dK and dQ", [
        ("WgRs<D>::mma(", "if (p.b < 0) WgRs<D>::mma(")]),
    "no_score_mma": ("the shared-memory wgmma of S and dP", [
        ("mxhop::wgmma_ss_n64(", "if (p.b < 0) mxhop::wgmma_ss_n64(")]),
}
SHAPES = {"bert_views": (32, 12, 512, 64, False, True),
          "proxy1b_causal": (8, 16, 2048, 128, True, False)}


def _build_variants(root: Path, source: str, variants: dict) -> dict:
    """Build each of ``variants`` (name: (what it takes out, [(text,
    replacement), ...])) of ``csrc/<source>`` in a copy of ``csrc/``
    under ``root``, all ``nvcc`` processes at once; returns the loaded
    libraries by name. An edit (file, text, replacement) edits another
    file of the copy."""
    shutil.rmtree(root, ignore_errors=True)
    for name, (_, edits) in variants.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        for edit in edits:
            path = d / (edit[0] if len(edit) == 3 else source)
            text, repl = edit[-2:]
            src = path.read_text()
            if text not in src:
                raise SystemExit(f"variant {name}: {text!r} is not in "
                                 f"{path.name}")
            path.write_text(src.replace(text, repl))
    procs = {}
    for name in variants:
        d = root / name
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                       stderr=subprocess.PIPE)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed:\n"
                             + err.decode()[-4000:])
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.mx_error_string.argtypes = [ctypes.c_int]
        lib.mx_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _inputs(b, h, l, d, views, gen):
    if views:
        qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen)
        q, k, v = (t.view(b, l, h, d)
                   for t in qkv.to(torch.bfloat16).split(h * d, dim=-1))
    else:
        q, k, v = (torch.randn(b, l, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
    do = torch.randn(b, l, h, d, device="cuda", generator=gen).to(
        torch.bfloat16)
    return q, k, v, do


def _time_ms(fn, flush, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in pairs:
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ablation: needs a CUDA card")
    libs = _build_variants(_build.REPO_ROOT / "build" / "ablation" / "bwd",
                           _SRC, VARIANTS)
    flush = torch.ones(32 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for key, (b, h, l, d, causal, views) in SHAPES.items():
        q, k, v, do = _inputs(b, h, l, d, views, gen)
        kw = {"causal": causal, "layout": "blhd"}
        o, lse = flash_attention_fwd(q, k, v, **kw)
        cases[key] = (q, k, v, o, lse, do, kw)
    summary = {}
    for name, lib in libs.items():
        _build._libs[_SRC] = lib
        for key, (q, k, v, o, lse, do, kw) in cases.items():
            def call():
                return flash_attention_bwd(q, k, v, o, lse, do, **kw)
            rec = {"variant": name, "takes_out": VARIANTS[name][0],
                   "shape": key, "ms": _time_ms(call, flush)}
            if name == "committed":
                got = call()
                want = flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                     **kw)
                rec["max_err_over_max_ref"] = max(
                    float((a.float() - r.float()).abs().max())
                    / float(r.float().abs().max())
                    for a, r in zip(got, want))
            summary.setdefault(key, {})[name] = rec["ms"]
            print(json.dumps(rec), flush=True)
    _build._libs.pop(_SRC, None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(json.dumps({"card": smi, "ms": summary}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
