"""How much a bf16 antialiased bilinear upscale's gradient varies from run
to run on the card: torch's bf16 route against resizing in f32.

    python -m mxnet_tpu_torch.tools.resize_bf16_probe

The case is ``tests/test_torch_cuda_vision.py``'s ``bilinear_up``: a (2,
8, 16, 16) input resized to 45 x 40 (``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)``, ``BilinearResize2D``'s call),
backward from a seeded bf16 head gradient, 20 times each way: in bf16
directly (torch's CUDA backward adds each output's share into the bf16
input gradient with atomics) and in f32 rounded once to bf16 (the
port's ``BilinearResize2D`` since it resizes bf16 in f32). Prints one
JSON line: for each way the number of distinct gradients over the 20
runs and the smallest and largest error against an f64 CPU resize of
the same bf16 values, relative to its largest magnitude, then the
card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F


def _up(t):
    return F.interpolate(t, size=(45, 40), mode="bilinear",
                         align_corners=False, antialias=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("resize_bf16_probe: needs a CUDA card")
    x = torch.from_numpy(np.random.RandomState(len("bilinear_up") + 90)
                         .randn(2, 8, 16, 16).astype(np.float32))
    ref_in = x.bfloat16().double().requires_grad_()
    ref_out = _up(ref_in)
    dy = torch.from_numpy(np.random.RandomState(2).randn(*ref_out.shape)
                          .astype(np.float32)).bfloat16()
    ref_out.backward(dy.double())
    want = ref_in.grad
    out = {}
    for name, up in (("bf16_direct", _up),
                     ("f32_inside", lambda t: _up(t.float()).to(t.dtype))):
        grads, errs = set(), []
        for _ in range(20):
            t = x.bfloat16().cuda().requires_grad_()
            up(t).backward(dy.cuda())
            g = t.grad.double().cpu()
            grads.add(g.numpy().tobytes())
            errs.append(float((g - want).abs().max() / want.abs().max()))
        out[name] = {"distinct_grads": len(grads), "max_err": max(errs),
                     "min_err": min(errs)}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
