"""Llama-style decoder-only LM and its paged-KV decode engine.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/llama.py``. The blocks are
``HybridBlock``s built in name scopes with the JAX blocks' prefixes and
attribute layout (``q_proj``, ``kv_proj``, ``out_proj``, ``gate_up``,
``down``, ``attn_norm``, ``mlp_norm``, ``embed``, ``norm``,
``lm_head``, the blocks as children ``layer0``, ``layer1``, ...), so a
``.params`` file of either package loads into the other's model and
:mod:`mxnet_tpu_torch.convert` carries weights across unchanged.

Two paths: the serving path, :class:`LlamaDecodeEngine` over
:func:`_paged_forward`, and the full-sequence causal ``forward`` that
pretraining runs under autograd (``parallel.TrainStep``): causal flash
attention in the "blhd" layout with the KV heads repeated up to the
query heads, RMSNorm through its forward and backward kernels, and with
``fused_ce`` the fused projection + cross-entropy head.
"""
from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from .... import initializer
from ....base import MXNetError, torch_dtype
from ....kernels._build import capture_graph, replay_counts
from ....ops.attention import paged_attention, rms_norm, rope_at
from ....ops.nn import embedding
from ...block import (HybridBlock, param_like, remat_call,
                      resolve_remat_policy)
from ... import nn
from .._build import materialize

__all__ = ["RMSNorm", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaDecodeEngine", "llama_tiny", "llama_3_8b",
           "llama_proxy1b"]


class RMSNorm(HybridBlock):
    """f32-statistics RMSNorm; on a CUDA input it runs the port's fused
    kernel (``_contrib_rms_norm``)."""

    def __init__(self, units, eps=1e-6, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.eps = eps
        with self.name_scope():
            self.weight = self.params.get("weight", shape=(units,),
                                          init="ones")

    def hybrid_forward(self, F, x, weight):
        return F._contrib_rms_norm(x, weight, eps=self.eps)


class LlamaAttention(HybridBlock):
    def __init__(self, units, num_heads, num_kv_heads=None,
                 rope_theta=10000.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        num_kv_heads = num_kv_heads or num_heads
        if num_heads % num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = units // num_heads
        self.rope_theta = rope_theta
        kw = {"flatten": False, "use_bias": False, "in_units": units}
        with self.name_scope():
            self.q_proj = nn.Dense(units, prefix="q_", **kw)
            self.kv_proj = nn.Dense(2 * num_kv_heads * self.head_dim,
                                    prefix="kv_", **kw)
            self.out_proj = nn.Dense(units, prefix="out_", **kw)

    def hybrid_forward(self, F, x):
        """(B, L, units) -> (B, L, units), causal, with rope on q and k
        (the JAX ``LlamaAttention.hybrid_forward``, ``llama.py:65-83``);
        the (B, L, H, D) heads go to attention as they are ("blhd")."""
        b, l = x.shape[0], x.shape[1]
        h, d = self.num_heads, self.head_dim
        q = self.q_proj(x).reshape((b, l, h, d))
        kv = self.kv_proj(x).reshape((b, l, 2 * self.num_kv_heads, d))
        k, v = F.split(kv, num_outputs=2, axis=2)
        q = F._contrib_rope(q, theta=self.rope_theta)
        k = F._contrib_rope(k, theta=self.rope_theta)
        if self.num_kv_heads != h:
            # F.repeat(k, repeats=rep, axis=1) in the JAX (B, H, L, D)
            rep = h // self.num_kv_heads
            k = F.repeat(k, repeats=rep, axis=2)
            v = F.repeat(v, repeats=rep, axis=2)
        out = F._contrib_sdp_attention(q, k, v, causal=True, layout="blhd")
        return self.out_proj(out.reshape((b, l, h * d)))


class LlamaMLP(HybridBlock):
    """SwiGLU: gate and up projected in ONE matmul, then silu(gate)*up."""

    def __init__(self, units, hidden_size, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.gate_up = nn.Dense(2 * hidden_size, flatten=False,
                                    use_bias=False, in_units=units,
                                    prefix="gateup_")
            self.down = nn.Dense(units, flatten=False, use_bias=False,
                                 in_units=hidden_size, prefix="down_")

    def hybrid_forward(self, F, x):
        gate, up = F.split(self.gate_up(x), num_outputs=2, axis=-1)
        return self.down(F.Activation(gate, act_type="silu") * up)


class LlamaBlock(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, num_kv_heads=None,
                 rope_theta=10000.0, eps=1e-6, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.attn_norm = RMSNorm(units, eps, prefix="attnnorm_")
            self.attention = LlamaAttention(units, num_heads, num_kv_heads,
                                            rope_theta, prefix="attn_")
            self.mlp_norm = RMSNorm(units, eps, prefix="mlpnorm_")
            self.mlp = LlamaMLP(units, hidden_size, prefix="mlp_")

    def hybrid_forward(self, F, x):
        x = x + self.attention(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


def _best_ce_chunk(vocab, target=8192):
    """Largest divisor of ``vocab`` <= target (the fused-CE tile that
    keeps the head free of vocabulary padding, e.g. 8192 for 32768 and
    8016 for Llama-3's 128256); a vocab <= target is its own chunk. Only
    when every divisor is degenerate (< target/4, a large near-prime
    vocab) fall back to ``target`` and the padded head (the JAX
    ``_best_ce_chunk``, ``llama.py:122-132``)."""
    if vocab <= target:
        return vocab
    for c in range(target, 0, -1):
        if vocab % c == 0:  # c=1 always divides, so this always returns
            return c if c >= target // 4 else target


class LlamaModel(HybridBlock):
    """Decoder-only causal LM, with the reference's parameter names
    (``llamamodel0_layer0_attn_q_weight``...) and structural names
    (``layer0.attention.q_proj.weight``: the blocks are children
    ``layer0``, ``layer1``, ..., listed in ``blocks``).

    Built as in the reference, it is not initialized; ``ctx=``,
    ``dtype=`` and ``generator=`` at construction initialize it at once
    (``ctx`` default: the card): N(0, 0.02) for the projections and the
    embedding and ones for the norms, drawn from ``generator`` (a
    ``torch.Generator`` on that device) when given, each parameter drawn
    in float32 and cast to ``dtype``.

    ``fused_ce``: ``forward(tokens, labels)`` returns the per-token loss
    through the fused projection + CE head over vocabulary chunks of
    ``ce_chunk`` (default: the largest divisor of the vocabulary up to
    8192), and the (B, L, vocab) logits never exist; otherwise
    ``forward(tokens)`` returns the logits.

    ``remat``: each block rematerialised in training
    (``gluon.block.remat_call``): True or ``"full"`` saves nothing,
    ``"dots"`` keeps the matrix products' outputs; False or None, none.
    ``tie_weights``: the head shares the embedding's parameter
    (``llamamodel0_embed_weight``, one entry of ``collect_params``, as
    in the reference)."""

    def __init__(self, vocab_size=128256, num_layers=32, units=4096,
                 hidden_size=14336, num_heads=32, num_kv_heads=8,
                 rope_theta=500000.0, eps=1e-5, tie_weights=False,
                 remat=False, fused_ce=False, ce_chunk=None, prefix=None,
                 params=None, ctx=None, dtype=None, generator=None):
        super().__init__(prefix=prefix, params=params)
        # a bool (True: the "full" policy) or a policy name, checked here
        self._remat = remat if isinstance(remat, str) else \
            ("full" if remat else None)
        resolve_remat_policy(self._remat)
        self._fused_ce = bool(fused_ce)
        if ce_chunk and vocab_size % int(ce_chunk):
            best = _best_ce_chunk(vocab_size)
            warnings.warn(
                f"ce_chunk={ce_chunk} does not divide vocab_size="
                f"{vocab_size}: the fused CE head takes the padded "
                "fallback with a vocab-sized synthetic-bias gradient"
                + (f"; a dividing chunk exists ({best})"
                   if vocab_size % best == 0 else ""),
                stacklevel=2)
        self._ce_chunk = int(ce_chunk) if ce_chunk else \
            _best_ce_chunk(vocab_size)
        num_kv = num_kv_heads or num_heads
        # architecture record for the paged decode engine
        self._decode_cfg = {
            "vocab_size": int(vocab_size), "num_layers": int(num_layers),
            "units": int(units), "num_heads": int(num_heads),
            "num_kv_heads": int(num_kv),
            "head_dim": int(units // num_heads),
            "rope_theta": float(rope_theta), "eps": float(eps),
        }
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, units, prefix="embed_")
            self.blocks = []
            for i in range(num_layers):
                blk = LlamaBlock(units, hidden_size, num_heads, num_kv_heads,
                                 rope_theta, eps, prefix=f"layer{i}_")
                self.blocks.append(blk)
                self.register_child(blk, f"layer{i}")
            self.norm = RMSNorm(units, eps, prefix="norm_")
            if tie_weights:
                self.lm_head = nn.Dense(vocab_size, in_units=units,
                                        flatten=False, use_bias=False,
                                        params=self.embed.params,
                                        prefix="embed_")
            else:
                self.lm_head = nn.Dense(vocab_size, in_units=units,
                                        flatten=False, use_bias=False,
                                        prefix="lm_head_")
        materialize(self, ctx, dtype, generator, initializer.Normal(0.02))

    def hybrid_forward(self, F, tokens, labels=None):
        """``tokens`` (B, L) integer ids; the (B, L, vocab) logits, or
        with ``fused_ce`` the (B, L) f32 per-token loss against
        ``labels`` (B, L)."""
        x = self.embed(tokens)
        for blk in self.blocks:
            x = remat_call(blk, x, policy=self._remat) if self._remat \
                else blk(x)
        h = self.norm(x)
        if self._fused_ce:
            if labels is None:
                raise ValueError(
                    "LlamaModel(fused_ce=True) takes (tokens, labels) and "
                    "returns the per-token loss")
            return F._contrib_softmax_ce_head(
                h, param_like(self.lm_head.weight, h), None, labels,
                chunk=self._ce_chunk)
        return self.lm_head(h)

    def decode_engine(self, pool, dtype="float32") -> "LlamaDecodeEngine":
        """The paged-KV decode engine for serving (the seam
        ``serving.Server`` calls to enable ``submit_generate``).
        ``pool``: a :class:`mxnet_tpu_torch.serving.kvcache.PagePool`."""
        return LlamaDecodeEngine(self, pool, dtype=dtype)


# ---------------------------------------------------------------------------
# paged-KV decode engine (serving)
# ---------------------------------------------------------------------------


def _paged_forward(params, tokens, positions, page_table, lengths,
                   k_arena, v_arena, *, cfg, page_size):
    """Cache-aware forward: embeds ``tokens`` (B, L) at absolute
    ``positions`` (B, L), writes each layer's K/V into the paged arenas,
    attends through the page table, and returns the logits (B, vocab) of
    the LAST valid input position per row.

    One function serves both phases: prefill is (B, len-bucket), decode
    is (B, 1). Positions at or beyond a row's ``lengths`` (bucket
    padding, whole-row batch padding) write into the reserved scratch
    page 0 and are masked out of every attention read.

    The arenas are updated IN PLACE (``index_copy_``); the JAX package
    rebuilt them functionally and returned them, because its arrays are
    immutable.
    """
    embed_w, layer_params, norm_w, head_w = params
    n_heads = cfg["num_heads"]
    n_kv = cfg["num_kv_heads"]
    d = cfg["head_dim"]
    theta = cfg["rope_theta"]
    eps = cfg["eps"]
    ps = int(page_size)
    b, l = tokens.shape
    w_pages = page_table.shape[1]

    x = embedding(tokens, embed_w)  # (B, L, U); NaN rows for a bad id
    real = positions < lengths[:, None]
    page_of = (positions // ps).clamp(0, w_pages - 1)
    page_ids = torch.gather(page_table.long(), 1, page_of)
    slot = torch.where(real, page_ids * ps + positions % ps,
                       positions % ps)                    # padding -> scratch
    slot_flat = slot.reshape(-1)

    for li, (anw, qw, kvw, ow, mnw, guw, dw) in enumerate(layer_params):
        h = rms_norm(x, anw, eps=eps)
        q = (h @ qw.T).reshape(b, l, n_heads, d)
        kv = (h @ kvw.T).reshape(b, l, 2 * n_kv, d)
        k, v = kv[:, :, :n_kv], kv[:, :, n_kv:]
        q = rope_at(q, positions, theta=theta)
        k = rope_at(k, positions, theta=theta)
        k_arena[li].index_copy_(0, slot_flat, k.reshape(b * l, n_kv, d))
        v_arena[li].index_copy_(0, slot_flat, v.reshape(b * l, n_kv, d))
        att = paged_attention(q.transpose(1, 2), k_arena[li], v_arena[li],
                              page_table, lengths, q_positions=positions,
                              page_size=ps)
        att = att.transpose(1, 2).reshape(b, l, n_heads * d)
        x = x + att @ ow.T
        hm = rms_norm(x, mnw, eps=eps)
        gate, up = (hm @ guw.T).chunk(2, dim=-1)
        x = x + (F.silu(gate) * up) @ dw.T

    hfin = rms_norm(x, norm_w, eps=eps)
    # the last REAL input row: index lengths-1-positions[:, 0]
    # (prefill: lengths-1; decode L=1: always 0)
    last = (lengths.long() - 1 - positions[:, 0]).clamp(0, l - 1)
    h_last = hfin[torch.arange(b, device=hfin.device), last]
    return h_last @ head_w.T


_DECODE_SITE = "serving_decode"
_engines = weakref.WeakSet()        # the live engines, for warm_start


def warm_decode_spec(model, spec) -> str:
    """``compiler.warm_start``'s ``serving_decode`` replay: capture the
    recorded bucket in each live engine of ``model`` with the recorded
    dtype and page size (an engine exists once a server serving the model
    has started); skipped when there is none."""
    engines = [e for e in list(_engines)
               if e._model() is model and e.page_size == spec["page_size"]
               and e._ident[2] == spec["dtype"]]
    if not engines:
        return "skipped"
    b, w = int(spec["batch"]), int(spec["width"])
    fresh = [e for e in engines if e._key(b, w) not in e._cache]
    for e in fresh:
        e._step(b, w, record=False)
    return "replayed" if fresh else "deduped"


class _DecodeStep:
    """One decode batch bucket's step: static input buffers on the
    engine's device (tokens, lengths, page table at a fixed (B, W)) and
    the body, :func:`_paged_forward` at L = 1 with positions
    ``lengths - 1``, that reads them.

    On the card the body is captured once into a CUDA graph
    (:meth:`capture`) and each step replays it; inputs arrive through
    pinned host staging buffers copied with ``non_blocking=True``, and
    the f32 logits leave through one copy into pinned memory. The
    kernel wrappers' launch counters tick when a wrapper runs, which a
    replay does not do: the capture records how far each counter moved,
    puts it back, and every replay adds that much. On the CPU, which
    has no graphs, the same body runs eagerly over the same buffers.

    The caller hands in every row of the bucket on every step (padding
    rows with length 0 and an all-scratch page table), so no page id of
    an earlier, fuller batch stays in the buffers. A step holds no
    reference to its engine: the engine's graphs are freed when the
    engine is, never by a cycle collection that could land inside
    another capture."""

    def __init__(self, engine, b: int, w: int):
        dev = engine.device
        self.tokens = torch.zeros((b, 1), dtype=torch.long, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.table = torch.zeros((b, w), dtype=torch.int32, device=dev)
        self.graph = None
        self.out = None
        self.launches = {}
        if dev.type == "cuda":
            pin = {"pin_memory": True}
            self.h_tokens = torch.zeros((b, 1), dtype=torch.long, **pin)
            self.h_lengths = torch.zeros((b,), dtype=torch.int32, **pin)
            self.h_table = torch.zeros((b, w), dtype=torch.int32, **pin)

    def body(self, e) -> torch.Tensor:
        positions = (self.lengths.long() - 1)[:, None]
        return _paged_forward(e._params, self.tokens, positions, self.table,
                              self.lengths, e.k_arena, e.v_arena,
                              cfg=e.cfg, page_size=e.page_size).float()

    @torch.no_grad()
    def capture(self, e, pool) -> None:
        """Capture the body (:func:`capture_graph`: a warm-up step on a
        side stream first). The buffers hold zeros, so the warm-up step's
        K/V writes land in scratch page 0. Raises :class:`MXNetError`
        when the capture fails; nothing runs eagerly in its place."""
        self.graph, self.out, self.launches = capture_graph(
            lambda: self.body(e), e.device, pool,
            f"LlamaDecodeEngine: capturing the decode graph of batch "
            f"bucket {tuple(self.table.shape)}")

    @torch.no_grad()
    def __call__(self, e, tokens, lengths, page_table) -> np.ndarray:
        if self.graph is None:
            self.tokens.copy_(torch.from_numpy(
                np.asarray(tokens, np.int64).reshape(-1, 1)))
            self.lengths.copy_(torch.from_numpy(
                np.asarray(lengths, np.int32)))
            self.table.copy_(torch.from_numpy(
                np.asarray(page_table, np.int32)))
            return self.body(e).numpy()
        self.h_tokens.numpy()[:] = np.asarray(tokens).reshape(-1, 1)
        self.h_lengths.numpy()[:] = lengths
        self.h_table.numpy()[:] = page_table
        self.tokens.copy_(self.h_tokens, non_blocking=True)
        self.lengths.copy_(self.h_lengths, non_blocking=True)
        self.table.copy_(self.h_table, non_blocking=True)
        self.graph.replay()
        replay_counts(self.launches)
        e.replays += 1
        # one copy into pinned memory (torch's host cache hands the block
        # back once the returned array is gone)
        out = torch.empty(self.out.shape, dtype=self.out.dtype,
                          pin_memory=True)
        out.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(e.device).synchronize()
        return out.numpy()


class LlamaDecodeEngine:
    """Cache-aware generation engine over one :class:`LlamaModel`.

    Owns the per-replica K/V arenas (pages allocated from ``pool``) on
    the model's device. Prefill runs :func:`_paged_forward` eagerly (one
    signature per (batch, len bucket)); each decode step runs one
    :class:`_DecodeStep` per (batch bucket, page-table width): on the
    card a CUDA graph, captured at :meth:`capture` (``Server.start``
    captures every bucket of its grid) or at the bucket's first step,
    and replayed — the counterpart of the JAX engine's one cached
    ``(batch, 1)`` executable per bucket. The engine's buckets share one
    graph memory pool. Numpy in, numpy f32 logits out, as in the JAX
    engine.

    The graphs read the weights where they lie: ``_params`` holds the
    model's own tensors when their dtype is the engine's (no copy), so
    :meth:`refresh_params` recaptures over a new model's tensors and
    never writes into the old model's. ``captures`` and ``replays``
    count the graphs captured and replayed (on the CPU, ``captures``
    counts the static-buffer steps built, at the same points).

    The steps live in the engine's own compilation-service site cache,
    ``SiteCache("serving_decode")`` (a graph binds its engine's buffers,
    so replicas never share one, and the graphs are freed with the
    engine), keyed by the engine's architecture, the bucket, the dtype
    and the page size; each is journaled to the signature manifest when
    one records, and ``compiler.warm_start(blocks=[model])`` captures
    the recorded buckets of the model's live engines, and only those
    (:func:`warm_decode_spec`).

    Not thread-safe by design: exactly one scheduler thread drives it
    (the :class:`~mxnet_tpu_torch.serving.server.Server` contract).
    """

    def __init__(self, model, pool, dtype="float32"):
        from ....compiler.service import SiteCache
        from ....serving.kvcache import make_kv_arena

        self.cfg = dict(model._decode_cfg)
        self.pool = pool
        self.page_size = pool.page_size
        self.dtype = torch_dtype(dtype)
        self.device = model.embed.weight.tensor.device
        self.k_arena, self.v_arena = make_kv_arena(
            self.cfg["num_layers"], pool, self.cfg["num_kv_heads"],
            self.cfg["head_dim"], dtype=self.dtype, device=self.device)
        self._ident = ("llama", tuple(sorted(self.cfg.items())),
                       str(self.dtype).split(".")[-1])
        self._cache = SiteCache(_DECODE_SITE)
        self._buckets = set()       # the (batch, width) buckets seated
        self._graph_pool = None     # the buckets' shared graph memory
        self.captures = 0
        self.replays = 0
        self._set_params(model)
        _engines.add(self)

    @torch.no_grad()
    def _set_params(self, model) -> None:
        """Extract the weights, cast to the engine dtype (no copy when
        the model already holds that dtype)."""
        def w(p):
            return p.tensor.detach().to(self.device, self.dtype)

        self._model = weakref.ref(model)

        self._params = (
            w(model.embed.weight),
            tuple((w(blk.attn_norm.weight), w(blk.attention.q_proj.weight),
                   w(blk.attention.kv_proj.weight),
                   w(blk.attention.out_proj.weight),
                   w(blk.mlp_norm.weight), w(blk.mlp.gate_up.weight),
                   w(blk.mlp.down.weight))
                  for blk in model.blocks),
            w(model.norm.weight), w(model.lm_head.weight))

    def refresh_params(self, model) -> None:
        """Serve ``model``'s weights from now on: drop every decode graph
        and recapture each bucket over the new tensors (one capture per
        bucket). The arenas stay where they are."""
        buckets = sorted(self._buckets)
        self._cache.clear()
        self._buckets.clear()
        # a pool whose graphs are all gone cannot take another capture
        self._graph_pool = None
        self._set_params(model)
        for b, w in buckets:
            self._step(b, w)

    def capture(self, batch_buckets, width: int) -> None:
        """Capture the decode graph of every batch size in
        ``batch_buckets`` at page-table width ``width`` (those not
        captured yet)."""
        for b in batch_buckets:
            self._step(int(b), int(width))

    def _key(self, b: int, w: int):
        from ....compiler import keys

        return keys.signature(
            _DECODE_SITE, self._ident,
            avals=((b, 1), (b, w), self._ident[2]), attrs=(self.page_size,),
            platform=keys.platform(self.device))

    def _step(self, b: int, w: int, record: bool = True) -> _DecodeStep:
        from ....compiler import manifest

        key = self._key(b, w)
        step = self._cache.lookup(key, record=record)
        if step is not self._cache.MISS:
            return step
        step = _DecodeStep(self, b, w)
        if self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            try:
                step.capture(self, self._graph_pool)
            except MXNetError:
                if not self._buckets:
                    self._graph_pool = None
                raise
        self._cache.insert(key, step)
        self._buckets.add((b, w))
        self.captures += 1
        model = self._model()
        if manifest.recorder() is not None and model is not None:
            from ....compiler import keys

            manifest.record_signature(_DECODE_SITE, {
                "graph": keys.graph_ident(model), "batch": b, "width": w,
                "dtype": self._ident[2], "page_size": self.page_size,
                "routing": key.routing}, key.platform)
        return step

    def buckets(self) -> list:
        """The (batch, page-table width) buckets with a decode step."""
        return sorted(self._buckets)

    def graph(self, b: int, w: int):
        """The captured ``torch.cuda.CUDAGraph`` of bucket ``(b, w)`` and
        the launch counts one replay adds (None on the CPU)."""
        step = self._cache.lookup(self._key(b, w), record=False)
        if step is self._cache.MISS:
            raise KeyError((b, w))
        return step.graph, dict(step.launches)

    def _tensor(self, a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def forward(self, tokens, positions, page_table, lengths) -> np.ndarray:
        """One eager cache-aware forward; numpy in, float32 numpy logits
        (B, vocab) out; the arenas advance in place."""
        logits = _paged_forward(
            self._params, self._tensor(tokens, torch.long),
            self._tensor(positions, torch.long),
            self._tensor(page_table, torch.int32),
            self._tensor(lengths, torch.int32),
            self.k_arena, self.v_arena, cfg=self.cfg,
            page_size=self.page_size)
        return logits.float().cpu().numpy()

    def prefill(self, tokens, lengths, page_table) -> np.ndarray:
        """Prefill (B, len-bucket) prompts; ``lengths`` are the real
        prompt lengths. Returns the next-token logits per row."""
        b, l = np.shape(tokens)
        positions = np.broadcast_to(np.arange(l, dtype=np.int64), (b, l))
        return self.forward(tokens, positions, page_table, lengths)

    def decode_step(self, tokens, lengths, page_table) -> np.ndarray:
        """One continuous-batching decode step: ``tokens`` (B,) are the
        rows' newest tokens, already counted in ``lengths``. Runs the
        step of bucket (B, page-table width): a graph replay on the
        card, capturing it first if this is the bucket's first step."""
        table = np.asarray(page_table)
        return self._step(*table.shape)(self, tokens, lengths, table)

    def decode_step_eager(self, tokens, lengths, page_table) -> np.ndarray:
        """The same step through :meth:`forward`, with no graph: the
        reference a replay is held against."""
        tokens = np.asarray(tokens).reshape(-1, 1)
        positions = (np.asarray(lengths, dtype=np.int64) - 1).reshape(-1, 1)
        return self.forward(tokens, positions, page_table, lengths)

    def apply_defrag(self, moves) -> None:
        """Replay :meth:`PagePool.defrag` page moves onto this engine's
        arenas (in place), before any dispatch reads the renumbered
        page tables."""
        from ....serving.kvcache import apply_defrag

        apply_defrag(self.k_arena, moves, self.page_size)
        apply_defrag(self.v_arena, moves, self.page_size)

    def forward_full(self, tokens) -> np.ndarray:
        """No-cache full-recompute oracle: run the whole (B, L) prefix
        through scratch pages and return the next-token logits. Frees its
        pages before returning."""
        tokens = np.asarray(tokens, dtype=np.int64)
        b, l = tokens.shape
        owners = [object() for _ in range(b)]
        table = np.zeros((b, self.pool.pages_for(l)), dtype=np.int32)
        try:
            for i, o in enumerate(owners):
                table[i] = self.pool.alloc(o, l)
            return self.prefill(tokens, np.full((b,), l, dtype=np.int32),
                                table)
        finally:
            for o in owners:
                self.pool.free(o)


def llama_tiny(**kwargs) -> LlamaModel:
    """Test-sized config (the JAX package's ``llama_tiny``)."""
    cfg = dict(vocab_size=256, num_layers=2, units=64, hidden_size=128,
               num_heads=4, num_kv_heads=2, rope_theta=10000.0)
    cfg.update(kwargs)
    return LlamaModel(**cfg)


def llama_proxy1b(**kwargs) -> LlamaModel:
    """The ~0.7B single-card proxy of the Llama-3-8B recipe (the JAX
    ``tools/pretrain_llama.py`` config ``proxy1b``): GQA 2:1 over heads
    of 128, SwiGLU, an untied head, rope theta 5e5."""
    cfg = dict(vocab_size=32768, num_layers=10, units=2048,
               hidden_size=7168, num_heads=16, num_kv_heads=8,
               rope_theta=500000.0)
    cfg.update(kwargs)
    return LlamaModel(**cfg)


def llama_3_8b(**kwargs) -> LlamaModel:
    """Llama-3-8B shapes."""
    cfg = dict(vocab_size=128256, num_layers=32, units=4096,
               hidden_size=14336, num_heads=32, num_kv_heads=8,
               rope_theta=500000.0)
    cfg.update(kwargs)
    return LlamaModel(**cfg)
