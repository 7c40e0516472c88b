"""Llama causal-LM pretraining on one card: the port of the JAX package's
``tools/pretrain_llama.py``.

    # the single-card proxy of the Llama-3-8B recipe at its benchmark shape
    python -m mxnet_tpu_torch.tools.pretrain_llama --config proxy1b \
        --steps 16 --batch 8 --seq 2048

    # test-sized, on the CPU (every kernel's plain version)
    python -m mxnet_tpu_torch.tools.pretrain_llama --config tiny --steps 3 \
        --ctx cpu

``LlamaModel(fused_ce=True)`` under ``parallel.TrainStep`` with
multi-precision AdamW (lr 3e-4, wd 0.1, beta 0.9 / 0.95), bf16 weights
drawn from seed 0, on synthetic ``RandomState(0)`` tokens staged on the
device once. Throughput is the synced span, as in the JAX tool: the
card is synchronised at the middle step and the remaining steps are
timed as one span that ends in a synchronisation. The last line is a
JSON record of the run, with every step's loss.

Not ported yet, each raising :class:`MXNetError` with its ROADMAP.md
item: a mesh over more than one device, ``--compile-only``, ``--data``
from a record file, ``--save-dir``, ``--remat`` and ``--no-fused-ce``.
Remat is off by default here (the JAX tool turns it on for every
config but ``tiny``; its own benchmark runs ``--no-remat``).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

CONFIGS = {
    # test-sized
    "tiny": dict(vocab_size=256, num_layers=2, units=64, hidden_size=128,
                 num_heads=4, num_kv_heads=2, rope_theta=10000.0),
    # ~0.7B single-chip proxy of the 8B recipe (same code path, same
    # ratios: GQA 2:1 over d=128 heads, SwiGLU ~3.5x, untied head)
    "proxy1b": dict(vocab_size=32768, num_layers=10, units=2048,
                    hidden_size=7168, num_heads=16, num_kv_heads=8,
                    rope_theta=500000.0),
    # Llama-3-8B
    "8b": dict(vocab_size=128256, num_layers=32, units=4096,
               hidden_size=14336, num_heads=32, num_kv_heads=8,
               rope_theta=500000.0),
}
# dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet)
H100_BF16_FLOPS = 989e12


def param_count(cfg):
    u, h, v = cfg["units"], cfg["hidden_size"], cfg["vocab_size"]
    d = u // cfg["num_heads"]
    kv = cfg["num_kv_heads"] * d
    per_layer = u * u + u * 2 * kv + u * u + 2 * u * h + h * u + 2 * u
    return cfg["num_layers"] * per_layer + 2 * v * u + u


def parse_mesh(spec):
    axes = {}
    if spec:
        for part in spec.split(","):
            k, v = part.split("=")
            axes[k.strip()] = int(v)
    return axes or {"dp": 1}


class _FusedLossPassthrough:
    """fused_ce=True: the model already returns per-token loss."""

    def __call__(self, outs, *a):
        return outs[0] if isinstance(outs, (list, tuple)) else outs


def _make_data(source, batch, seq, vocab, device):
    """Synthetic next-token batches: ``RandomState(0)`` ids, drawn once
    and staged on ``device``, yielded again and again (the JAX tool's
    ``_make_data`` with its staged batch; int32 labels, as the fused CE
    head takes them)."""
    from ..base import MXNetError

    if source != "synthetic":
        raise MXNetError(f"--data {source}: record files need the "
                         "runtime-services slice (recordio, ROADMAP.md, "
                         "port queue 1, item 10)")
    rs = np.random.RandomState(0)
    toks = rs.randint(0, vocab, (batch, seq + 1))
    tokens = torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device)
    labels = torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device)
    while True:
        yield tokens, labels


def build(config, *, ctx=None, dtype="bfloat16", lr=3e-4,
          weight_decay=0.1):
    """``(net, step)``: ``LlamaModel(**CONFIGS[config], fused_ce=True)``
    on ``ctx`` in ``dtype``, its weights drawn from seed 0, under a
    ``TrainStep`` with the pretraining tool's multi-precision AdamW."""
    from .. import parallel
    from ..base import torch_dtype
    from ..context import resolve_device
    from ..gluon.model_zoo.nlp.llama import LlamaModel

    device = resolve_device(ctx)
    gen = torch.Generator(device=device).manual_seed(0)
    net = LlamaModel(**CONFIGS[config], fused_ce=True, ctx=device,
                     dtype=torch_dtype(dtype), generator=gen)
    step = parallel.TrainStep(
        net, _FusedLossPassthrough(), "adamw", loss_only=True,
        optimizer_params={"learning_rate": lr, "wd": weight_decay,
                          "beta1": 0.9, "beta2": 0.95,
                          "multi_precision": True})
    return net, step


def _refuse(args) -> None:
    from ..base import MXNetError

    world = math.prod(parse_mesh(args.mesh).values())
    for flag, bad, item in (
            (f"--mesh {args.mesh}", world > 1,
             "the data-parallel comms and parallelism slices, items 9 and "
             "11"),
            ("--compile-only", args.compile_only,
             "the compilation service, item 10"),
            ("--save-dir", args.save_dir is not None,
             "checkpointing, item 10"),
            ("--remat", args.remat not in (None, False),
             "TrainStep's remat, item 8"),
            ("--no-fused-ce", not args.fused_ce,
             "gluon/loss.py, item 6")):
        if bad:
            raise MXNetError(f"{flag} is not ported yet (ROADMAP.md, port "
                             f"queue 1, {item})")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    ap.add_argument("--mesh", default="", help="e.g. dp=2,tp=2,sp=2")
    ap.add_argument("--batch", type=int, default=None, help="global batch")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--remat", nargs="?", const=True, default=None)
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--no-fused-ce", dest="fused_ce", action="store_false",
                    default=True)
    ap.add_argument("--compile-only", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"),
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    _refuse(args)

    from .. import context

    cfg = dict(CONFIGS[args.config])
    n_params = param_count(cfg)
    seq = args.seq or (2048 if args.config != "tiny" else 128)
    batch = args.batch or (4 if args.config == "proxy1b" else 2)
    device = context.cpu() if args.ctx == "cpu" else context.gpu(0)
    data = _make_data(args.data, batch, seq, cfg["vocab_size"], device)
    _, step = build(args.config, ctx=device, dtype=args.dtype, lr=args.lr,
                    weight_decay=args.weight_decay)
    tokens, labels = next(data)

    t0 = time.perf_counter()
    losses = [step((tokens, labels), ())[0]]
    print(f"step 1: loss {float(losses[0]):.4f} (first step "
          f"{time.perf_counter() - t0:.1f}s; {n_params / 1e6:.0f}M params, "
          f"{device})", flush=True)
    # synced span: synchronise at the middle step, time the rest as one
    # span that ends in a synchronisation
    sync_at = min(max(2, args.steps // 2), max(args.steps - 1, 1))
    t_span, span_steps = None, 0
    for i in range(2, args.steps + 1):
        tokens, labels = next(data)
        losses.append(step((tokens, labels), ())[0])
        if i == sync_at:
            _sync(device)
            t_span = time.perf_counter()
        elif i > sync_at:
            span_steps += 1
    _sync(device)
    if t_span is not None and span_steps > 0:
        tok_s = batch * seq * span_steps / (time.perf_counter() - t_span)
    else:           # too few steps for a span: the whole run
        tok_s = batch * seq * args.steps / (time.perf_counter() - t0)
    losses = [float(x) for x in losses]
    on_card = device.type == "cuda"
    print(json.dumps({
        "config": args.config, "params": n_params, "batch": batch,
        "seq": seq, "device": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
        "tokens_per_sec": tok_s,
        # MFU is a device metric: the card's only
        "mfu": 6.0 * n_params * tok_s / H100_BF16_FLOPS if on_card else None,
        "final_loss": losses[-1], "losses": losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
