"""Time the ``box_nms`` kernels of several checkouts, in turns, on one card.

    python3 mxnet_tpu_torch/tools/nms_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository. Each runs in
a process of its own, which builds and imports that checkout's
``kernels/box_nms.py``. The rows, the timers and the flush are this
checkout's ``chip_smoke.py``'s (loaded by path, whatever the checkout
under test), so every checkout is timed on ``nms_case``'s data with its
yardsticks: SSD detect's rows (``_nms_detect_rows``: 32 images of 7,620
seeded rows [id, score, box], 20 classes; ``NMS_DETECT_KW``: per class,
overlap 0.45, valid 0.01), at ``topk`` 400 (SSD detect's) and at the
op's default ``topk=-1``. It measures:

* ``ms``: ``time_ms``, the median of 20 CUDA event pairs, each after a
  read of 128 MB that leaves the L2 cold; ``device_ms``: ``_queued_ms``,
  the same with every call queued behind a sleep kernel, so that a pair
  times the device alone;
* ``host_us``: the host's microseconds a call, over 200 calls queued
  without a sync (the wrapper's Python, the ``ctypes`` call and the
  launches);
* ``kernels_per_call``: the kernel nodes of a CUDA graph capture of one
  call;
* ``scratch_bytes``: the peak of allocated memory during one call above
  the inputs and the output;
* ``bits``: a SHA-256 of the output, equal across checkouts that decide
  alike, and ``same_as_plain``: the output against the checkout's plain
  version (``box_nms_sorted_reference``, four images at a time).

Prints the card's name and power limit, one JSON line per run and a
last line with every run; exits non-zero if a run failed. Give the
checkouts in the order old, new, new, old, so that a drift of the card
over the call shows.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SMOKE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     os.pardir, os.pardir, "chip_smoke.py")


def load_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its top level
    imports only numpy and torch)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_nms_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


_RUN = r"""
import hashlib, json, sys, time
sys.path.insert(0, {root!r})
import torch
from mxnet_tpu_torch.kernels import box_nms_sorted, box_nms_sorted_reference
from mxnet_tpu_torch.kernels import _build

sys.path.insert(1, {tools!r})
from nms_ab import load_smoke

smoke = load_smoke()
_build.build_all()
flush = smoke._L2Flush()
rows = smoke._nms_detect_rows()
kw = smoke.NMS_DETECT_KW
batch = rows.shape[0]


def host_us(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


res = {{}}
for topk in (400, -1):
    srt, n = smoke._sorted_nms_rows(rows, topk)
    call = lambda: box_nms_sorted(srt, n, **kw)
    got = call()
    want = torch.cat([box_nms_sorted_reference(srt[i:i + 4], n, **kw)
                      for i in range(0, batch, 4)])
    same = smoke._nan_same(got, want)
    del want
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base - got.numel() * 4
    res[str(topk)] = {{
        "m": srt.shape[1], "ms": smoke.time_ms(call, flush),
        "device_ms": smoke._queued_ms(call, flush), "host_us": host_us(call),
        "kernels_per_call": _build.kernels_per_call(call),
        "scratch_bytes": scratch, "same_as_plain": same,
        "kept_per_image": float((got[..., 0] >= 0).sum()) / batch,
        "valid_rows_per_image": float(
            (srt[..., 1] > kw["valid_thresh"]).sum()) / batch,
        "bits": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()}}
print(json.dumps(res))
"""


def run_tree(root: str) -> dict:
    root = os.path.abspath(root)
    tools = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, "-c",
                        _RUN.format(root=root, tools=tools)],
                       cwd=root, capture_output=True, text=True,
                       timeout=900)
    out = {"tree": root, "rc": p.returncode}
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if p.returncode == 0 and lines:
        out.update(json.loads(lines[-1]))
    else:
        out["stderr_tail"] = p.stderr[-2000:]
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs = []
    for root in argv:
        r = run_tree(root)
        r["card"] = card.strip()
        print(json.dumps(r), flush=True)
        runs.append(r)
    print(json.dumps({"runs": runs}), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
