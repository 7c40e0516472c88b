"""Cold-start meter of the compilation service on the card: the port of
the JAX package's ``tools/coldstart_bench.py``.

    python -m mxnet_tpu_torch.tools.coldstart_bench [--seed 0]
        [--tier build/coldstart]

Each regime runs in fresh processes (cold start is a process property),
one for each path:

1. **import -> first response**: a Llama-3-8B serving replica (all 32
   layers, bf16, weights from ``--seed``) behind ``serving.Server`` with
   decode graphs per batch bucket (1, 2, 4, 8), and the hybridized
   BERT-base predict at (32, 128) and (32, 512) through a head that
   scales the pooled output with a user kernel of ``mx.rtc`` (NVRTC),
   held bit for bit against its plain version;
   two generate requests (prompts of 100 and 300 tokens, 16 new tokens)
   one after the other, then the two BERT predicts;
2. **import -> first train step**: proxy1b (``tools/pretrain_llama.py``'s
   single-card config, remat off, batch 8 x 2048), one step.

Three regimes, as in the reference:

* ``cold``          — the NVRTC tier emptied and no manifest used (the
  run records one, ``MXNET_COMPILE_MANIFEST``); the ``nvcc`` outputs are
  kept (a full rebuild takes minutes and is measured once, by
  ``chip_smoke.py``'s ``build`` phase): every graph is captured and the
  user kernel compiled by NVRTC;
* ``warm_disk``     — the NVRTC tier the cold run filled: the CUBIN is
  read from disk; graphs are captured as in ``cold``;
* ``warm_manifest`` — the disk tier and ``compiler.warm_start`` over the
  cold run's manifest before the first request (the server starts with
  ``warmup=False``; ``warm_start`` captures the recorded decode buckets
  and BERT signatures, makes the train step's states, loads the
  kernels).

Reported per regime and path: seconds from the package's import to each
event (``warm_start_done``, ``first_response``, ``first_train_step``),
the first dispatch's latency, the site caches' misses after warm-up
(``cached_op``, ``serving_decode``, ``train_step``), the NVRTC compiles
and disk loads, and the responses' and first loss's bits against the
cold run. The warm-manifest serving run also zeroes the launch counters
before its first request and reports the kernels each warmed graph
launches per replay. It exits non-zero unless the warm-manifest runs
record zero misses, give the cold run's responses and first loss bit for
bit, read the CUBIN from disk with no NVRTC compile, and launch rows 1,
2, 1', 3, 10 and 13 inside the graphs ``warm_start`` captured. The
reference's 2x speedup bar is a TPU figure and is not a gate here. The
last line is JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REGIMES = ("cold", "warm_disk", "warm_manifest")
BATCH_BUCKETS = (1, 2, 4, 8)
BERT_SHAPES = ((32, 128), (32, 512))
PROMPT_LENS = (100, 300)
NEW_TOKENS = 16
TRAIN_BATCH = (8, 2048)
# the user kernel of the BERT head (row 13 of PERF.md's kernel table)
SCALE_SOURCE = r"""
#include <cuda_bf16.h>
extern "C" __global__ void scale_bf16(const __nv_bfloat16 *x,
                                      __nv_bfloat16 *y, float alpha, int n)
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = __float2bfloat16(__bfloat162float(x[i]) * alpha);
}
"""
ALPHA = 0.5
# the kernels the warmed graphs must launch, by PERF.md's row
ROWS = {"1": "fused_rms_norm", "2": "paged_attention_kernel",
        "1'": "fused_layer_norm", "3": "flash_attention",
        "10": "fused_bias_gelu", "13": "mx.rtc:scale_bf16"}


def _manifest_path(tier: Path) -> Path:
    return tier / "manifests" / "coldstart.jsonl"


# ---------------------------------------------------------------------------
# the children
# ---------------------------------------------------------------------------

def _counter_name(key) -> str:
    fn, attr = key
    name = getattr(fn, "__name__", None) or f"mx.rtc:{fn.name}"
    return name if attr == "launches" else f"{name}.{attr}"


def _zero_counters() -> None:
    from mxnet_tpu_torch.kernels import launch_counters

    for fn, attr in launch_counters():
        setattr(fn, attr, 0)


def _counts() -> dict:
    from mxnet_tpu_torch.kernels import launch_counters

    return {_counter_name(k): v for k, v in launch_counters().items() if v}


def _sha(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def _bert_head(seed):
    """``bert_12_768_12`` (pooler and classifier, no decoder, bf16, as
    ``chip_smoke.py``'s gluon phase builds it) under a head that returns
    the sequence output and the pooled output scaled by ``ALPHA`` by the
    user kernel, hybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12

    class _RtcHead(HybridBlock):
        def __init__(self, prefix=None):
            super().__init__(prefix=prefix)
            with self.name_scope():
                self.bert = bert_12_768_12(use_pooler=True,
                                           use_classifier=True,
                                           use_decoder=False)
            self.module = mx.rtc.CudaModule(SCALE_SOURCE)
            self.kernel = self.module.get_kernel(
                "scale_bf16", "const __nv_bfloat16 *x, __nv_bfloat16 *y, "
                "float alpha, int n")

        def hybrid_forward(self, F, tokens, types):
            seq, pooled, _ = self.bert(tokens, types)
            y = F.zeros_like(pooled)
            n = pooled.size
            self.kernel.launch([pooled, y, ALPHA, n], pooled.context,
                               ((n + 255) // 256,), (256,))
            return seq, pooled, y

    mx.random.seed(seed + 8)
    head = _RtcHead(prefix="coldstart_")
    head.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0))
    head.cast("bfloat16")
    head.hybridize()
    return head


def _bert_inputs(b, l, seed):
    import numpy as np

    import mxnet_tpu_torch as mx

    rs = np.random.RandomState(seed + b * 1000 + l)
    return [mx.nd.array(rs.randint(1, 30522, (b, l)), ctx=mx.gpu(0),
                        dtype="float32"),
            mx.nd.array(rs.randint(0, 2, (b, l)), ctx=mx.gpu(0),
                        dtype="float32")]


def _graph_launches(head, engine) -> dict:
    """The kernels each captured graph launches per replay, by name."""
    out = {}
    for key, captured in head._graph()._graphs.items():
        out[f"cached_op{list(key.avals[0][0])}"] = {
            _counter_name(k): v for k, v in captured.launches.items()}
    for b, w in engine.buckets():
        _, per = engine.graph(b, w)
        out[f"serving_decode[{b}, {w}]"] = {
            _counter_name(k): v for k, v in per.items()}
    return out


def child_serve(regime, seed, tier) -> dict:
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compiler
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_3_8b

    import_s = compiler.seconds_since_import()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    llama = llama_3_8b(ctx=mx.gpu(0), dtype=torch.bfloat16, generator=gen)
    head = _bert_head(seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = regime == "warm_manifest"
    srv = mx.serving.Server(llama, dtype="bfloat16", decode_pages=512,
                            page_size=16, batch_buckets=BATCH_BUCKETS,
                            len_buckets=(128, 512), warmup=not warm)
    srv.start()
    report = None
    if warm:
        report = compiler.warm_start(str(_manifest_path(tier)),
                                     blocks=[llama, head])
    decode, cached = srv.engine._cache, head._graph()._cache
    captures = (srv.engine.captures, head._graph().captures)
    misses = (decode.misses, cached.misses)
    _zero_counters()
    rs = np.random.RandomState(seed)
    tokens, latency = [], {}
    for i, n in enumerate(PROMPT_LENS):
        prompt = rs.randint(0, 128256, size=n).astype(np.int32)
        t = time.perf_counter()
        tokens.append([int(x) for x in srv.submit_generate(
            prompt, NEW_TOKENS).result(600)])
        latency[f"generate_{i}_ms"] = (time.perf_counter() - t) * 1e3
    outs = []
    for b, l in BERT_SHAPES:
        args = _bert_inputs(b, l, seed)
        t = time.perf_counter()
        seq, pooled, y = head(*args)
        got = [t._data.float().cpu().numpy() for t in (seq, pooled, y)]
        latency[f"bert_{b}x{l}_ms"] = (time.perf_counter() - t) * 1e3
        plain = (pooled._data.float() * ALPHA).bfloat16().float()
        if not torch.equal(y._data.float(), plain):
            raise SystemExit(f"the user kernel's output at ({b}, {l}) is "
                             "not its plain version's")
        outs += got
    torch.cuda.synchronize()
    srv.stop()
    return {
        "regime": regime, "path": "serve",
        "import_s": import_s, "build_s": build_s,
        "events": compiler.events(), "warm_report": report,
        "first_dispatch_ms": latency["generate_0_ms"], "latency": latency,
        "misses_after_warmup": {
            "serving_decode": decode.misses - misses[0],
            "cached_op": cached.misses - misses[1]},
        "captures_after_warmup": {
            "serving_decode": srv.engine.captures - captures[0],
            "cached_op": head._graph().captures - captures[1]},
        "nvrtc": {"compiles": mx.rtc.CudaModule.compiles,
                  "disk_loads": mx.rtc.CudaModule.disk_loads,
                  "image_source": head.module.image_source,
                  "compile_ms": head.module.compile_ms},
        "launches": _counts(),
        "graph_launches": _graph_launches(head, srv.engine),
        "tokens": tokens, "bert_sha256": _sha(outs),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def child_train(regime, seed, tier) -> dict:
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import compiler
    from mxnet_tpu_torch.tools import pretrain_llama

    import_s = compiler.seconds_since_import()
    t0 = time.perf_counter()
    mx.random.seed(seed)
    net, step = pretrain_llama.build("proxy1b", ctx=mx.gpu(0), remat=False)
    b, s = TRAIN_BATCH
    toks = np.random.RandomState(seed).randint(0, 32768, (b, s + 1))
    tokens = torch.from_numpy(toks[:, :-1].astype(np.int32)).cuda()
    labels = torch.from_numpy(toks[:, 1:].astype(np.int32)).cuda()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    report = None
    if regime == "warm_manifest":
        report = compiler.warm_start(str(_manifest_path(tier)),
                                     train_steps=[step])
    misses = step._cache.misses
    t = time.perf_counter()
    loss = step((tokens, labels), ())[0]
    loss_bits = loss.float().cpu().numpy().tobytes().hex()
    first_ms = (time.perf_counter() - t) * 1e3
    return {"regime": regime, "path": "train", "config": "proxy1b",
            "batch": list(TRAIN_BATCH), "import_s": import_s,
            "build_s": build_s, "events": compiler.events(),
            "warm_report": report, "first_dispatch_ms": first_ms,
            "misses_after_warmup": {"train_step":
                                    step._cache.misses - misses},
            "loss": float(loss), "loss_hex": loss_bits}


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _run_child(path, regime, args, tier) -> dict:
    env = dict(os.environ, MXNET_XLA_CACHE_DIR=str(tier),
               MXNET_COMPILE_MANIFEST=str(_manifest_path(tier))
               if regime == "cold" else "0")
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.coldstart_bench",
           "--child", path, "--regime", regime, "--seed", str(args.seed),
           "--tier", str(tier)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve()
                          .parents[2])
    if proc.returncode != 0:
        raise SystemExit(f"coldstart {regime}/{path} failed "
                         f"(rc={proc.returncode}):\n{proc.stderr[-6000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["process_s"] = time.perf_counter() - t
    return rec


def _prepare_tier(tier: Path) -> str:
    """Copy this checkout's kernel build into the tier (built here first
    if it is missing), so no child rebuilds it; empty the NVRTC tier and
    the manifest for the cold run."""
    from mxnet_tpu_torch.kernels import _build

    live = _build.build_all()
    dest = tier / "kernels" / live.name
    if not dest.exists():
        shutil.copytree(live, dest)
    shutil.rmtree(tier / "nvrtc", ignore_errors=True)
    man = _manifest_path(tier)
    if man.exists():
        man.unlink()
    return live.name


def gates(runs) -> dict:
    """The meter's gates over ``runs[regime][path]``."""
    cold, warm = runs["cold"], runs["warm_manifest"]
    ws, wt = warm["serve"], warm["train"]
    launched = {}
    for row, name in ROWS.items():
        in_graphs = any(name in per for per in ws["graph_launches"].values())
        launched[row] = in_graphs and ws["launches"].get(name, 0) > 0
    out = {
        "zero_misses_after_warm": (
            not any(ws["misses_after_warmup"].values())
            and not any(ws["captures_after_warmup"].values())
            and not any(wt["misses_after_warmup"].values())),
        "bit_identical": all(
            runs[r]["serve"]["tokens"] == cold["serve"]["tokens"]
            and runs[r]["serve"]["bert_sha256"]
            == cold["serve"]["bert_sha256"]
            and runs[r]["train"]["loss_hex"] == cold["train"]["loss_hex"]
            for r in REGIMES),
        "cubin_from_disk": all(
            runs[r]["serve"]["nvrtc"]["compiles"] == 0
            and runs[r]["serve"]["nvrtc"]["image_source"] == "disk"
            for r in ("warm_disk", "warm_manifest"))
        and cold["serve"]["nvrtc"]["compiles"] >= 1,
        "warm_start_failed": sum(warm[p]["warm_report"]["failed"]
                                 for p in ("serve", "train")),
        "rows_launched_in_warmed_graphs": launched}
    out["ok"] = (out["zero_misses_after_warm"] and out["bit_identical"]
                 and out["cubin_from_disk"]
                 and out["warm_start_failed"] == 0
                 and all(launched.values()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tier", default=None,
                    help="the disk tier's directory (default "
                         "build/coldstart)")
    ap.add_argument("--child", choices=("serve", "train"), default=None)
    ap.add_argument("--regime", choices=REGIMES, default=None)
    args = ap.parse_args(argv)
    repo = Path(__file__).resolve().parents[2]
    tier = Path(args.tier) if args.tier else repo / "build" / "coldstart"
    if args.child == "serve":
        print(json.dumps(child_serve(args.regime, args.seed, tier)),
              flush=True)
        return 0
    if args.child == "train":
        print(json.dumps(child_train(args.regime, args.seed, tier)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("coldstart_bench measures the card: "
                         "torch.cuda.is_available() is False")
    build = _prepare_tier(tier)
    runs = {}
    for regime in REGIMES:
        runs[regime] = {path: _run_child(path, regime, args, tier)
                        for path in ("serve", "train")}
        for path, rec in runs[regime].items():
            print(json.dumps({k: rec[k] for k in (
                "regime", "path", "events", "first_dispatch_ms",
                "misses_after_warmup", "process_s")}), flush=True)
    verdict = gates(runs)
    print(json.dumps({"coldstart": runs, "gates": verdict, "build": build,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
