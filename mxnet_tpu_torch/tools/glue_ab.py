"""Time the Llama training step's activation and embedding ops in several
checkouts, in turns, on one card.

    python3 mxnet_tpu_torch/tools/glue_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository. Each runs in
a process of its own, which imports that checkout's ``ops/nn.py`` and
times, with CUDA events (median of 20 after 3 warm-up calls), at
proxy1b's shapes (``tools/pretrain_llama.py``, batch 8 x 2048):

* ``silu``: ``Activation(act_type="silu")`` over the SwiGLU gate, (16384,
  7168) bf16, forward alone and forward plus backward;
* ``embedding``: the ``Embedding`` op, (8, 2048) int32 ids into a
  (32768, 2048) bf16 table, forward alone and forward plus backward.

Prints the card's name and power limit, one JSON line per run and a
last line with every run; exits non-zero if a run failed. Give the
checkouts in the order old, new, new, old, so that a drift of the card
over the call shows.
"""
from __future__ import annotations

import json
import subprocess
import sys

_RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
from mxnet_tpu_torch.ops import nn


def med(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(16384, 7168, device="cuda", generator=g,
                dtype=torch.bfloat16).requires_grad_()
gy = torch.randn(16384, 7168, device="cuda", generator=g,
                 dtype=torch.bfloat16)
act = nn._ACTIVATIONS["silu"]
ids = torch.randint(0, 32768, (8, 2048), device="cuda", generator=g,
                    dtype=torch.int32)
w = torch.randn(32768, 2048, device="cuda", generator=g,
                dtype=torch.bfloat16).requires_grad_()
ge = torch.randn(8, 2048, 2048, device="cuda", generator=g,
                 dtype=torch.bfloat16)


def silu_fwd():
    with torch.no_grad():
        act(x)


def silu_fwd_bwd():
    x.grad = None
    torch.autograd.backward(act(x), gy)


def emb_fwd():
    with torch.no_grad():
        nn.embedding(ids, w)


def emb_fwd_bwd():
    w.grad = None
    torch.autograd.backward(nn.embedding(ids, w), ge)


print(json.dumps({{"silu_fwd_ms": med(silu_fwd),
                  "silu_fwd_bwd_ms": med(silu_fwd_bwd),
                  "embedding_fwd_ms": med(emb_fwd),
                  "embedding_fwd_bwd_ms": med(emb_fwd_bwd)}}))
"""


def run_tree(root: str) -> dict:
    import os

    root = os.path.abspath(root)
    p = subprocess.run([sys.executable, "-c", _RUN.format(root=root)],
                       cwd=root, capture_output=True, text=True,
                       timeout=600)
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
