"""Llama causal-LM pretraining on one card: the port of the JAX package's
``tools/pretrain_llama.py``.

    # the single-card proxy of the Llama-3-8B recipe at its benchmark shape
    python -m mxnet_tpu_torch.tools.pretrain_llama --config proxy1b \
        --steps 16 --batch 8 --seq 2048

    # test-sized, on the CPU (every kernel's plain version)
    python -m mxnet_tpu_torch.tools.pretrain_llama --config tiny --steps 3 \
        --ctx cpu

    # from a record file of int32 token ids, checkpointed every 100 steps
    python -m mxnet_tpu_torch.tools.pretrain_llama --config proxy1b \
        --data tokens.rec --save-dir ckpt --save-every 100

``LlamaModel(fused_ce=True)`` under ``parallel.TrainStep`` with
multi-precision AdamW (lr 3e-4, wd 0.1, beta 0.9 / 0.95), bf16 weights
drawn from seed 0. Data (``_make_data``, as the JAX tool's): ``--data
synthetic`` (the default) draws ``RandomState(0)`` tokens once and
stages them on the device; ``--data <path.rec>`` reads records of int32
ids with ``mx.recordio`` (a record shorter than seq + 1 is skipped;
tokens ``arr[:seq]``, labels ``arr[1:seq + 1]``; the file is reopened at
its end, forever), a new batch every step. Throughput is the synced
span, as in the JAX tool: the card is synchronised at the middle step
and the remaining steps are timed as one span that ends in a
synchronisation, with the checkpoint writes taken out. The last line is
a JSON record of the run, with every step's loss.

``--save-dir`` writes ``llama-{step:07d}.params`` (``save_parameters``,
loadable by the JAX package's ``LlamaModel``) and
``llama-{step:07d}.states``, the JAX tool's pickle ``{"num_update",
"leaves"}``: per trainable parameter its optimizer state flattened in
order (the f32 master, then the moments), as the JAX ``TrainStep``'s
``_state_leaf_nds``; every ``--save-every`` steps and after the last.

Remat follows the JAX tool (``:111``): each block is rematerialised
(``LlamaModel(remat=...)``) for every config but ``tiny``, ``--remat
[full|dots]`` picks the policy (bare ``--remat`` is ``full``) and
``--no-remat`` turns it off, as the JAX benchmark (``bench_llama.py``)
runs.

``--compile-only`` (the JAX tool's ``_compile_only``, ``:285-334``)
checks the recipe without its weights: the net is built under
``gluon.parameter.abstract_init()`` on the ``meta`` device and
``TrainStep.aot_compile`` runs the step's state code and its forward
and backward there, so not one byte of weights reaches the card. The
last line is the JAX tool's JSON (``config``, ``compile_only``,
``params``, ``mesh`` (``{}`` on one card), ``batch``, ``seq``,
``remat``, ``compile_s``, ``argument_bytes_per_device``,
``temp_bytes_per_device``) with ``flops_per_step`` (the step's count,
``telemetry.xla_cost_analysis``), ``fits`` (arguments and temporaries
against ``torch.cuda.mem_get_info``'s total; None on the CPU),
``params_in_net`` and the card's ``device_max_allocated_bytes``::

    python -m mxnet_tpu_torch.tools.pretrain_llama --config 8b --compile-only

Not ported yet, each raising :class:`MXNetError` with its ROADMAP.md
item: a mesh over more than one device and ``--no-fused-ce``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pickle
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
    """Next-token batches ``(tokens, labels)``, int32 (the fused CE head
    takes int32 labels), on ``device``: ``"synthetic"`` is
    ``RandomState(0)`` ids drawn once, staged once and yielded again and
    again; a path is a record file of int32 ids read forever (the JAX
    tool's ``_make_data``)."""
    if source == "synthetic":
        rs = np.random.RandomState(0)
        toks = rs.randint(0, vocab, (batch, seq + 1))
        tokens = torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device)
        labels = torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device)
        while True:
            yield tokens, labels
    yield from _record_batches(source, batch, seq, device)


def _record_batches(path, batch, seq, device):
    """Batches of ``batch`` records of ``path``: each record's first
    ``seq`` ids and the same shifted by one; a record shorter than seq +
    1 is skipped, a batch left partial at the end of the file is
    dropped, and the file is reopened there. Host batches are pinned so
    the copy to the card does not wait for the queued steps."""
    from ..base import MXNetError
    from ..recordio import MXRecordIO

    def put(rows):
        t = torch.from_numpy(np.stack(rows))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    while True:
        reader = MXRecordIO(path, "r")
        buf_t, buf_l, full = [], [], 0
        while True:
            rec = reader.read()
            if rec is None:
                break
            arr = np.frombuffer(rec, dtype=np.int32)
            if arr.shape[0] < seq + 1:
                continue
            buf_t.append(arr[:seq])
            buf_l.append(arr[1:seq + 1])
            if len(buf_t) == batch:
                full += 1
                yield put(buf_t), put(buf_l)
                buf_t, buf_l = [], []
        reader.close()
        if not full:
            raise MXNetError(f"--data {path}: no {batch} records of at "
                             f"least seq + 1 = {seq + 1} int32 ids")


def _state_leaves(state) -> list:
    """An optimizer state's tensors in the order the JAX package's
    ``jax.tree_util.tree_flatten`` lists them (tuples in order, None
    skipped), as host numpy."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [leaf for s in state for leaf in _state_leaves(s)]
    t = getattr(state, "_data", state)         # an NDArray's tensor
    return [t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16
            else t.detach().cpu().numpy()]


def _save(net, step, save_dir, i) -> list:
    """Write ``llama-{i:07d}.params`` and ``.states`` under ``save_dir``
    (the JAX tool's ``_save``); returns the two paths."""
    from ..checkpoint import atomic_write

    os.makedirs(save_dir, exist_ok=True)
    params = os.path.join(save_dir, f"llama-{i:07d}.params")
    states = os.path.join(save_dir, f"llama-{i:07d}.states")
    net.save_parameters(params)
    leaves = [leaf for st in (step._states or []) for leaf in
              _state_leaves(st)]
    atomic_write(states, pickle.dumps(
        {"num_update": step.optimizer.num_update, "leaves": leaves}))
    print(f"saved checkpoint @ step {i} -> {save_dir}", flush=True)
    return [params, states]


def default_remat(config):
    """The driver's remat when neither ``--remat`` nor ``--no-remat`` is
    given: ``"full"`` for every config but ``tiny``."""
    return "full" if config != "tiny" else None


def resolve_remat(config, remat):
    """``--remat``'s value as ``LlamaModel``'s ``remat``: None (the flag
    absent) takes :func:`default_remat`; False is off; True is
    ``"full"``; a policy name passes through."""
    if remat is None:
        return default_remat(config)
    if remat is True:
        return "full"
    return remat or None


def build(config, *, ctx=None, dtype="bfloat16", lr=3e-4,
          weight_decay=0.1, remat=None, abstract=False):
    """``(net, step)``: ``LlamaModel(**CONFIGS[config], fused_ce=True,
    remat=...)`` on ``ctx`` in ``dtype``, its weights drawn from seed 0,
    under a ``TrainStep`` with the pretraining tool's multi-precision
    AdamW. ``remat`` as ``--remat`` takes it (:func:`resolve_remat`:
    None is the driver's default, on for every config but ``tiny``).
    ``abstract``: built under ``abstract_init()``, its parameters on the
    ``meta`` device and nothing drawn (``--compile-only``)."""
    from .. import parallel
    from ..base import torch_dtype
    from ..context import resolve_device
    from ..gluon.model_zoo.nlp.llama import LlamaModel
    from ..gluon.parameter import abstract_init

    device = resolve_device(ctx)
    kw = dict(CONFIGS[config], fused_ce=True, ctx=device,
              dtype=torch_dtype(dtype), remat=resolve_remat(config, remat))
    if abstract:
        with abstract_init():
            net = LlamaModel(**kw)
    else:
        net = LlamaModel(**kw, generator=torch.Generator(
            device=device).manual_seed(0))
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
             "the parallelism slice, item 11"),
            ("--no-fused-ce", not args.fused_ce,
             "gluon/loss.py, item 6")):
        if bad:
            raise MXNetError(f"{flag} is not ported yet (ROADMAP.md, port "
                             f"queue 1, {item})")
    if args.save_every < 1:
        raise MXNetError(f"--save-every {args.save_every}: must be at "
                         "least 1")


def _compile_only(args, device, batch, seq, remat) -> int:
    """``--compile-only``: the step on the ``meta`` device (see the module
    docstring); prints the JSON line."""
    n_params = param_count(CONFIGS[args.config])
    t0 = time.perf_counter()
    net, step = build(args.config, ctx=device, dtype=args.dtype, lr=args.lr,
                      weight_decay=args.weight_decay, remat=args.remat,
                      abstract=True)
    tok = (torch.Size([batch, seq]), torch.int32)
    # the fused head takes its labels as the model's second data input
    compiled = step.aot_compile((tok, tok), ())
    mem = compiled.memory_analysis()
    on_card = device.type == "cuda"
    need = mem.argument_size_in_bytes + mem.temp_size_in_bytes
    print(json.dumps({
        "config": args.config, "compile_only": True, "params": n_params,
        "mesh": {}, "batch": batch, "seq": seq, "remat": bool(remat),
        "compile_s": round(time.perf_counter() - t0, 1),
        "argument_bytes_per_device": mem.argument_size_in_bytes,
        "temp_bytes_per_device": mem.temp_size_in_bytes,
        "flops_per_step": compiled.cost_analysis()["flops"],
        "fits": need <= torch.cuda.mem_get_info(device)[1] if on_card
        else None,
        "params_in_net": sum(p.numel() for p in net.parameters()),
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "device_max_allocated_bytes": torch.cuda.max_memory_allocated(device)
        if on_card else None}))
    return 0


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
    ap.add_argument("--remat", nargs="?", const=True, default=None,
                    choices=("full", "dots", True),
                    help="rematerialise each block; the optional value "
                         "picks the policy (default: on for every config "
                         "but tiny)")
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--no-fused-ce", dest="fused_ce", action="store_false",
                    default=True)
    ap.add_argument("--compile-only", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"),
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    _refuse(args)

    from ..context import cpu, resolve_device

    cfg = dict(CONFIGS[args.config])
    n_params = param_count(cfg)
    seq = args.seq or (2048 if args.config != "tiny" else 128)
    batch = args.batch or (4 if args.config == "proxy1b" else 2)
    device = resolve_device(cpu() if args.ctx == "cpu" else None)
    if args.compile_only:
        return _compile_only(args, device, batch, seq,
                             resolve_remat(args.config, args.remat))
    data = _make_data(args.data, batch, seq, cfg["vocab_size"], device)
    remat = resolve_remat(args.config, args.remat)
    # build resolves --remat itself: given the resolved None (--no-remat)
    # it would take the config's default again
    net, step = build(args.config, ctx=device, dtype=args.dtype, lr=args.lr,
                      weight_decay=args.weight_decay, remat=args.remat)
    tokens, labels = next(data)

    t0 = time.perf_counter()
    losses = [step((tokens, labels), ())[0]]
    print(f"step 1: loss {float(losses[0]):.4f} (first step "
          f"{time.perf_counter() - t0:.1f}s; {n_params / 1e6:.0f}M params, "
          f"{device})", flush=True)
    # synced span: synchronise at the middle step, time the rest as one
    # span that ends in a synchronisation; checkpoint writes are taken out
    sync_at = min(max(2, args.steps // 2), max(args.steps - 1, 1))
    t_span, span_steps, save_s = None, 0, 0.0
    t_end = None
    for i in range(2, args.steps + 1):
        tokens, labels = next(data)
        losses.append(step((tokens, labels), ())[0])
        if i == sync_at:
            _sync(device)
            t_span = time.perf_counter()
        elif i > sync_at:
            span_steps += 1
        if i == args.steps:
            _sync(device)
            t_end = time.perf_counter()
        if args.save_dir and i % args.save_every == 0:
            # the queued steps finish first: the host copy of the weights
            # would wait for them, and that wait is the steps' time
            _sync(device)
            t_save = time.perf_counter()
            _save(net, step, args.save_dir, i)
            if t_span is not None and i < args.steps:
                save_s += time.perf_counter() - t_save
    if t_end is None:           # --steps 1
        _sync(device)
        t_end = time.perf_counter()
    if args.save_dir and args.steps % args.save_every != 0:
        _save(net, step, args.save_dir, args.steps)
    if t_span is not None and span_steps > 0:
        tok_s = batch * seq * span_steps / (t_end - t_span - save_s)
    else:           # too few steps for a span: the whole run
        tok_s = batch * seq * args.steps / (t_end - t0)
    losses = [float(x) for x in losses]
    on_card = device.type == "cuda"
    print(json.dumps({
        "config": args.config, "params": n_params, "batch": batch,
        "seq": seq, "remat": remat,
        "device": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
        "tokens_per_sec": tok_s,
        # MFU is a device metric: the card's only
        "mfu": 6.0 * n_params * tok_s / H100_BF16_FLOPS if on_card else None,
        "final_loss": losses[-1], "losses": losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
