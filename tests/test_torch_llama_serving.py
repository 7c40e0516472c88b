"""The port's Llama serving slice held against the JAX package on the CPU:
weight conversion, the paged decode engine, the continuous-batching
generate server, and the port's device and import rules.

Weights are drawn once with numpy, set on a JAX ``llama_tiny`` (GQA 2:1)
and carried into the port by ``mxnet_tpu_torch.convert``; both packages
run in float32 on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo.nlp import llama_tiny as jax_llama_tiny
from mxnet_tpu.serving.kvcache import PagePool as JaxPagePool
from mxnet_tpu.serving.kvcache import apply_defrag as jax_apply_defrag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import llama_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_tiny
from mxnet_tpu_torch.serving import CacheFull, PagePool, Server
from mxnet_tpu_torch.serving.kvcache import apply_defrag, make_kv_arena

pytestmark = pytest.mark.serving

# f32 logits of a 2-layer model: the two frameworks sum the same
# products in different orders (GEMM blocking, softmax reductions)
LOGIT_TOL = 1e-4
PAGE = 4


@pytest.fixture(scope="module")
def nets():
    """(jax net, port net, numpy params) with identical weights, drawn
    with a fixed numpy seed at a scale that spreads the logits (no
    near-ties for greedy decode to break differently)."""
    jnet = jax_llama_tiny()
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 2), dtype="int32"))
    rs = np.random.RandomState(11)
    named = {}
    for name, p in jnet.collect_params().items():
        shape = p.shape
        if name.endswith("norm_weight"):
            arr = 1.0 + 0.1 * rs.randn(*shape)
        else:
            arr = rs.randn(*shape) / np.sqrt(shape[-1])
        arr = arr.astype(np.float32)
        p.set_data(jmx.nd.array(arr))
        named[name] = arr
    pnet = llama_tiny(ctx=mx.cpu())
    pnet.load_state_dict(llama_params_from_reference(named))
    return jnet, pnet, named


def _server_kw(**kw):
    base = dict(batch_buckets=(1, 2, 4), slo_ms=500.0, dtype="float32",
                decode_pages=64, page_size=PAGE, len_buckets=(8, 16))
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# weight carrier
# ---------------------------------------------------------------------------

def test_convert_maps_every_name_and_raises_on_mismatch(nets):
    _, pnet, named = nets
    sd = llama_params_from_reference(named)
    assert set(sd) == set(pnet.state_dict())
    for key, t in pnet.state_dict().items():
        assert torch.equal(sd[key], t)
    # the JAX model's name prefix ("llamamodel<N>_") depends on how many
    # models the process built before this one
    prefix = next(n for n in named if n.endswith("embed_weight"))[
        :-len("embed_weight")]
    missing = dict(named)
    missing.pop(prefix + "layer1_mlp_down_weight")
    extra = dict(named)
    extra[prefix + "layer0_attn_bias"] = np.zeros(4, np.float32)
    bad_shape = dict(named)
    bad_shape[prefix + "layer1_attn_out_weight"] = np.zeros((64, 32),
                                                            np.float32)
    for case in (missing, extra, bad_shape):
        with pytest.raises(mx.MXNetError):
            llama_params_from_reference(case)


# ---------------------------------------------------------------------------
# decode engine
# ---------------------------------------------------------------------------

def test_engine_prefill_and_decode_match_jax(nets):
    jnet, pnet, _ = nets
    jeng = jnet.decode_engine(JaxPagePool(24, PAGE), dtype="float32")
    peng = pnet.decode_engine(PagePool(24, PAGE), dtype="float32")
    prompts = [np.array([5, 17, 3, 99, 250], np.int32),
               np.array([7, 1, 8, 2, 8, 1, 8], np.int32)]
    tokens = np.zeros((2, 8), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    # rows own pages 1-4 and 5-8; the tail column pads with scratch 0
    table = np.array([[1, 2, 3, 4, 0], [5, 6, 7, 8, 0]], np.int32)
    jl = jeng.prefill(tokens, lengths, table)
    pl = peng.prefill(tokens, lengths, table)
    np.testing.assert_allclose(pl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for _ in range(5):
        nxt = np.argmax(jl, axis=-1).astype(np.int32)
        np.testing.assert_array_equal(np.argmax(pl, axis=-1), nxt)
        lengths = lengths + 1
        jl = jeng.decode_step(nxt, lengths, table)
        pl = peng.decode_step(nxt, lengths, table)
        np.testing.assert_allclose(pl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_cached_decode_chain_matches_forward_full_chain(nets):
    _, pnet, _ = nets
    eng = pnet.decode_engine(PagePool(24, PAGE), dtype="float32")
    prompt = [9, 4, 200, 31, 7, 7]
    table = np.array([[1, 2, 3, 4, 5]], np.int32)
    logits = eng.prefill(np.array([prompt + [0, 0]], np.int32),
                         np.array([len(prompt)], np.int32), table)
    seq = list(prompt)
    for _ in range(8):
        full = eng.forward_full(np.array([seq], np.int32))
        # same greedy chain; logits to f32 reduction-order noise
        assert int(np.argmax(full)) == int(np.argmax(logits))
        np.testing.assert_allclose(logits, full, rtol=1e-5, atol=1e-5)
        seq.append(int(np.argmax(logits)))
        logits = eng.decode_step(np.array([seq[-1]], np.int32),
                                 np.array([len(seq)], np.int32), table)
    assert eng.pool.stats()["owners"] == 0      # forward_full freed pages


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

PROMPTS = [np.array([3, 1, 4], np.int32),
           np.array([2, 7, 1, 8, 2, 8], np.int32),
           np.array([1, 6, 1, 8, 0, 3, 3, 9, 8], np.int32),
           np.array([5, 77, 5, 66, 4, 3, 2, 1, 90, 12, 11, 250], np.int32)]
MAX_NEW = [5, 9, 3, 6]


def _run_generates(srv):
    """Three streams start together; the fourth joins once stream 1 has
    streamed two tokens. Streams leave at their own budgets."""
    hs = [srv.submit_generate(p, n) for p, n in zip(PROMPTS[:3],
                                                    MAX_NEW[:3])]
    assert hs[1].next_token(1, timeout=60) is not None
    hs.append(srv.submit_generate(PROMPTS[3], MAX_NEW[3]))
    return [h.result(timeout=60) for h in hs]


def test_server_generate_matches_jax_server(nets):
    jnet, pnet, _ = nets
    with Server(pnet, ctx=mx.cpu(), **_server_kw()) as srv:
        got = _run_generates(srv)
        stats = srv.stats()
    with jserving.Server(jnet, warmup=False, **_server_kw()) as jsrv:
        want = _run_generates(jsrv)
    for g, w, n in zip(got, want, MAX_NEW):
        assert g.dtype == np.int32 and len(g) == n
        np.testing.assert_array_equal(g, w)
    assert stats["tokens"] == sum(MAX_NEW)
    assert stats["requests"] == 4 and stats["errors"] == 0
    assert stats["kvcache"]["used"] == 0


def test_concurrent_submitters_all_complete(nets):
    """Six threads submit at once under a short switch interval: every
    stream completes with the tokens it gets when served alone, and the
    shared counters lose no update."""
    import threading

    _, pnet, _ = nets
    prompts = [np.arange(3 + i, dtype=np.int32) * (i + 5) % 256
               for i in range(6)]
    with Server(pnet, ctx=mx.cpu(), **_server_kw()) as srv:
        alone = [srv.submit_generate(p, 4).result(60) for p in prompts]
    got = [None] * len(prompts)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Server(pnet, ctx=mx.cpu(), **_server_kw()) as srv:
            def submit(i):
                got[i] = srv.submit_generate(prompts[i], 4).result(60)

            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            stats = srv.stats()
    finally:
        sys.setswitchinterval(old)
    for g, a in zip(got, alone):
        np.testing.assert_array_equal(g, a)
    assert stats["requests"] == len(prompts)
    assert stats["tokens"] == 4 * len(prompts)


def test_rejections_are_typed_and_synchronous(nets):
    _, pnet, _ = nets
    srv = Server(pnet, ctx=mx.cpu(), **_server_kw(max_generate_tokens=20))
    with pytest.raises(mx.MXNetError):
        srv.submit_generate(PROMPTS[0], 2)          # not running yet
    with srv:
        with pytest.raises(CacheFull):
            srv.submit_generate(PROMPTS[3], 9)      # 12 + 9 > 20
        with pytest.raises(mx.MXNetError, match="no len bucket"):
            srv.submit_generate(np.arange(17, dtype=np.int32), 1)
        with pytest.raises(mx.MXNetError):
            srv.submit_generate(np.zeros(0, np.int32), 1)
        assert len(srv.submit_generate(PROMPTS[0], 2).result(60)) == 2
    assert srv.stats()["shed"] == 1
    # without decode_pages the server serves one-shot submit only
    with Server(pnet, ctx=mx.cpu(), batch_buckets=(1,)) as plain:
        with pytest.raises(mx.MXNetError, match="decode is not enabled"):
            plain.submit_generate(PROMPTS[0], 2)


def test_defrag_keeps_output_unchanged(nets):
    _, pnet, _ = nets

    def run(threshold):
        with Server(pnet, ctx=mx.cpu(), **_server_kw(
                decode_pages=40, defrag_threshold=threshold)) as srv:
            # the short stream frees the low pages while the long one
            # still decodes from higher ones: holes below the high-water
            # mark trigger a pack
            short = srv.submit_generate(PROMPTS[0], 2)
            long = srv.submit_generate(PROMPTS[1], 20)
            out = (short.result(60), long.result(60))
            return out, srv.stats()["defrags"]

    (s0, l0), n0 = run(None)
    (s1, l1), n1 = run(0.05)
    assert n0 == 0 and n1 >= 1
    np.testing.assert_array_equal(s0, s1)
    np.testing.assert_array_equal(l0, l1)


def test_deadline_and_non_drain_stop_fail_typed(nets):
    _, pnet, _ = nets
    srv = Server(pnet, ctx=mx.cpu(), **_server_kw()).start()
    try:
        late = srv.submit_generate(PROMPTS[1], 4, deadline_ms=1e-3)
        with pytest.raises(mx.MXNetError, match="deadline"):
            late.result(60)
        long = srv.submit_generate(PROMPTS[2], 200)
        assert long.next_token(0, timeout=60) is not None
    finally:
        srv.stop(drain=False, timeout=60)
    with pytest.raises(mx.MXNetError, match="stopped"):
        long.result(60)
    assert long.next_token(len(long.tokens()), timeout=1) is None
    assert srv.stats()["kvcache"]["used"] == 0 and not srv.is_running


def test_page_pool_and_bucket_grid_match_jax():
    """The copied accounting modules behave as the JAX package's on one
    sequence of allocations, growth, frees and a defrag."""
    from mxnet_tpu.serving.buckets import BucketGrid as JaxGrid
    from mxnet_tpu_torch.serving import BucketGrid

    pools = (JaxPagePool(12, page_size=4), PagePool(12, page_size=4))
    logs = []
    for pool in pools:
        log = [pool.alloc("a", 9), pool.alloc("b", 4), pool.alloc("c", 13)]
        log.append(pool.extend("b", 10))
        log.append(pool.free("a"))
        log.append(pool.frag_info())
        log.append(pool.defrag())
        log.append([pool.owned(o) for o in "abc"])
        log.append(pool.page_table("c", width=6).tolist())
        log.append(pool.stats())
        logs.append(log)
    assert logs[0] == logs[1]
    grids = (JaxGrid((1, 2, 8), len_buckets=(16, 64)),
             BucketGrid((1, 2, 8), len_buckets=(16, 64)))
    for n in range(1, 9):
        assert grids[0].batch_bucket(n) == grids[1].batch_bucket(n)
    for n in (1, 16, 17, 64):
        assert grids[0].prefill_bucket(n) == grids[1].prefill_bucket(n)
    assert grids[0].generate_signatures() == grids[1].generate_signatures()


def test_apply_defrag_matches_jax():
    rs = np.random.RandomState(2)
    arena = rs.randn(2, 8 * PAGE, 2, 4).astype(np.float32)
    moves = [(5, 1), (7, 2), (6, 3)]
    got = apply_defrag(torch.from_numpy(arena.copy()), moves, PAGE)
    want = jax_apply_defrag(jnp.asarray(arena), moves, PAGE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the port's device and import rules
# ---------------------------------------------------------------------------

def test_default_device_entry_points_raise_without_cuda(nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _, pnet, _ = nets
    with pytest.raises(mx.MXNetError):
        mx.gpu()
    with pytest.raises(mx.MXNetError):
        llama_tiny().initialize()
    with pytest.raises(mx.MXNetError):
        Server(pnet, **_server_kw())
    with pytest.raises(mx.MXNetError):
        make_kv_arena(1, PagePool(4, PAGE), 2, 16)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch, "
            "mxnet_tpu_torch.tools.pretrain_llama\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
