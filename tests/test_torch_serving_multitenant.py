"""The port's multi-tenant serving held against the JAX package on the
CPU: the tenant registry, per-tenant token-bucket throttling,
weighted-fair decode slots, priority preemption at the decode-step
boundary, automatic defrag, per-tenant upgrade, fault injection at
``serving.dispatch``, and the telemetry the server exports — the
contracts of ``tests/test_serving_multitenant.py`` and
``tests/test_serving.py``, on ``llama_tiny`` with f32 weights drawn with
numpy and carried into the port by ``mxnet_tpu_torch.convert``.
"""
import re
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fault as jfault
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.gluon.model_zoo.nlp import llama_tiny as jax_llama_tiny

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fault, telemetry, tracing
from mxnet_tpu_torch.convert import llama_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_tiny
from mxnet_tpu_torch.serving import (DEFAULT_MODEL, Preempted, Server,
                                     TenantThrottled)

pytestmark = pytest.mark.serving

PROMPT = np.array([3, 1, 4, 1, 5], dtype=np.int32)
PAGE = 4
_PAIRS = {}


def pair(seed):
    """(jax net, port net) of ``llama_tiny`` with the same f32 weights,
    drawn from ``seed`` at a scale that spreads the logits (no near-ties
    for greedy decode to break differently)."""
    if seed not in _PAIRS:
        jnet = jax_llama_tiny()
        jnet.initialize()
        jnet(jmx.nd.zeros((1, 2), dtype="int32"))
        rs = np.random.RandomState(seed)
        named = {}
        for name, p in jnet.collect_params().items():
            if name.endswith("norm_weight"):
                arr = 1.0 + 0.1 * rs.randn(*p.shape)
            else:
                arr = rs.randn(*p.shape) / np.sqrt(p.shape[-1])
            named[name] = arr.astype(np.float32)
            p.set_data(jmx.nd.array(named[name]))
        pnet = llama_tiny(ctx=mx.cpu())
        pnet.load_state_dict(llama_params_from_reference(named))
        _PAIRS[seed] = (jnet, pnet)
    return _PAIRS[seed]


@torch.no_grad()
def oracle(pnet, prompt, n_new):
    """Full-recompute greedy decode through ``LlamaModel.forward``."""
    toks = [int(t) for t in prompt]
    for _ in range(n_new):
        logits = pnet(torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    return np.asarray(toks[len(prompt):], dtype=np.int32)


def server_kw(**kw):
    base = dict(batch_buckets=(1, 2), slo_ms=60000.0, dtype="int32",
                decode_pages=96, page_size=PAGE, len_buckets=(8, 16))
    base.update(kw)
    return base


def port_server(net, **kw):
    return Server(net, ctx=mx.cpu(), **server_kw(**kw))


def jax_server(net, **kw):
    return jserving.Server(net, warmup=False, **server_kw(**kw))


def wait_until(pred, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


PROMPTS = [np.array([3, 1, 4], np.int32),
           np.array([2, 7, 1, 8, 2, 8], np.int32),
           np.array([1, 6, 1, 8, 0, 3, 3, 9, 8], np.int32)]


def _two_tenants(make, srv_net, b_net):
    """Each prompt to the default tenant and to tenant "b" (weight 2),
    all submitted together; returns (default tokens, b tokens)."""
    with make(srv_net) as srv:
        srv.register_model("b", b_net, weight=2.0)
        hs = [(srv.submit_generate(p, 6),
               srv.submit_generate(p, 6, model="b")) for p in PROMPTS]
        return ([a.result(120) for a, _ in hs],
                [b.result(120) for _, b in hs])


# ---------------------------------------------------------------------------
# tenant registry
# ---------------------------------------------------------------------------

def test_register_models_and_stats():
    _, pa = pair(7)
    _, pb = pair(11)
    srv = port_server(pa)
    srv.register_model("b", pb, slo_class="premium", priority=5, weight=2.0)
    assert srv.models() == ["b", DEFAULT_MODEL]
    ms = srv.stats()["models"]
    assert ms["b"]["slo_class"] == "premium"
    assert ms["b"]["priority"] == 5 and ms["b"]["weight"] == 2.0
    assert ms[DEFAULT_MODEL]["slo_class"] == "standard"
    assert srv.current_model("b") is pb and srv.current_model() is pa
    with pytest.raises(mx.MXNetError, match="already registered"):
        srv.register_model("b", pa)
    with pytest.raises(mx.MXNetError, match="weight"):
        srv.register_model("c", pa, weight=0.0)
    with srv:
        with pytest.raises(mx.MXNetError, match="unknown model"):
            srv.submit_generate(PROMPT, 2, model="ghost")


def test_tenant_tokens_match_the_jax_server():
    """Tokens routed to the default tenant and to a registered one are
    the JAX server's, stream for stream, with the same weights."""
    ja, pa = pair(7)
    jb, pb = pair(11)
    got = _two_tenants(port_server, pa, pb)
    want = _two_tenants(jax_server, ja, jb)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert len(g) == 6
        np.testing.assert_array_equal(g, w)
    assert not all(np.array_equal(a, b) for a, b in zip(*got))


# ---------------------------------------------------------------------------
# per-tenant token buckets
# ---------------------------------------------------------------------------

def test_throttle_sheds_typed_synchronously_and_scoped_to_one_tenant():
    _, pa = pair(7)
    _, pb = pair(11)
    with port_server(pa) as srv:
        # a refill rate of ~0/s makes the burst the whole budget
        srv.register_model("lim", pb, rate_limit=1e-6, burst=2)
        hs = [srv.submit_generate(PROMPT, 2, model="lim") for _ in range(2)]
        with pytest.raises(TenantThrottled):
            srv.submit_generate(PROMPT, 2, model="lim")
        # the neighbour tenant is untouched by lim's empty bucket
        out = srv.submit_generate(PROMPT, 2).result(120)
        for h in hs:
            assert len(h.result(120)) == 2
        ms = srv.stats()["models"]
    assert ms["lim"]["shed"] == 1 and ms[DEFAULT_MODEL]["shed"] == 0
    assert ms["lim"]["requests"] == 3 and len(out) == 2


# ---------------------------------------------------------------------------
# weighted-fair decode slots
# ---------------------------------------------------------------------------

def test_decode_token_share_tracks_weights():
    _, pa = pair(7)
    _, pb = pair(11)
    n_new, streams = 48, 4
    pages_per = -(-(PROMPT.size + n_new) // PAGE)
    srv = port_server(pa, batch_buckets=(4,),
                      decode_pages=2 * streams * pages_per + 1,
                      max_generate_tokens=PROMPT.size + n_new, weight=1.0)
    srv.start()
    try:
        srv.register_model("fast", pb, weight=3.0)

        def tokens():
            ms = srv.stats()["models"]
            return ms[DEFAULT_MODEL]["tokens"], ms["fast"]["tokens"]

        handles = []
        for _ in range(streams):
            handles.append(srv.submit_generate(PROMPT, n_new))
            handles.append(srv.submit_generate(PROMPT, n_new, model="fast"))
        base = tokens()
        wait_until(lambda: (srv.stats()["generates_active"] == 2 * streams
                            and sum(tokens()) - sum(base) >= 24),
                   timeout=120, msg="both tenants decoding steadily")
        a1, b1 = tokens()
        wait_until(lambda: (tokens()[0] - a1) + (tokens()[1] - b1) >= 96,
                   timeout=120, msg="the measurement window's tokens")
        a2, b2 = tokens()
        share_fast = (b2 - b1) / ((a2 - a1) + (b2 - b1))
        # weights 3:1 over 4 decode slots a round: "fast" takes 3 of 4
        assert abs(share_fast - 0.75) / 0.75 <= 0.10
        for h in handles:
            assert len(h.result(120)) == n_new
    finally:
        srv.stop(drain=False)


# ---------------------------------------------------------------------------
# priority preemption at the decode-step boundary
# ---------------------------------------------------------------------------

def test_preemption_contract():
    _, p_lo = pair(7)
    _, p_hi = pair(11)
    low_new, hi_new = 40, 8
    orc_lo = oracle(p_lo, PROMPT, low_new)
    orc_hi = oracle(p_hi, PROMPT, hi_new)
    tracing.reset()
    tracing.enable()
    srv = port_server(p_lo, decode_pages=40, len_buckets=(8, 16, 32, 64),
                      max_generate_tokens=PROMPT.size + low_new, priority=0)
    srv.start()
    try:
        srv.register_model("premium", p_hi, slo_class="premium",
                           priority=10)
        # 3 low-priority squatters reserve 3 x 12 of 39 usable pages;
        # the premium arrival needs 4 -> it must preempt
        lows = [srv.submit_generate(PROMPT, low_new) for _ in range(3)]
        wait_until(lambda: srv.stats()["generates_active"] >= 3,
                   msg="squatters admitted")
        his = [srv.submit_generate(PROMPT, hi_new, model="premium")
               for _ in range(2)]
        for h in his:
            np.testing.assert_array_equal(h.result(120), orc_hi)
        n_preempted = 0
        for h in lows:
            try:
                got = h.result(120)
            except Preempted:
                n_preempted += 1
                got = h.tokens()
                # a sealed prefix: never another token after the end
                assert h.next_token(len(got), timeout=1) is None
            np.testing.assert_array_equal(np.asarray(got, np.int32),
                                          orc_lo[:len(got)])
        assert n_preempted >= 1
        events = tracing.events("preempted")
        assert len(events) == n_preempted
        for e in events:
            assert e["victim_model"] == DEFAULT_MODEL
            assert e["beneficiary_model"] == "premium"
            assert e["victim_priority"] == 0
            assert e["beneficiary_priority"] == 10
            assert e["replica"] == srv.name
            assert isinstance(e["victim"], int)
            assert isinstance(e["beneficiary"], int)
            assert 0 <= e["victim_tokens"] < low_new
        st = srv.stats()
        assert st["preemptions"] == n_preempted
        assert st["models"][DEFAULT_MODEL]["preempted"] == n_preempted
        assert st["kvcache"]["used"] == 0
    finally:
        srv.stop(drain=False)
        tracing.reset()


def test_a_lower_priority_arrival_never_evicts():
    _, p_hi = pair(7)
    _, p_lo = pair(11)
    tracing.reset()
    tracing.enable()
    srv = port_server(p_hi, decode_pages=40, len_buckets=(8, 16, 32, 64),
                      max_generate_tokens=PROMPT.size + 40, priority=10)
    srv.start()
    try:
        srv.register_model("low", p_lo, priority=0)
        highs = [srv.submit_generate(PROMPT, 40) for _ in range(3)]
        wait_until(lambda: srv.stats()["generates_active"] >= 3,
                   msg="high-priority streams admitted")
        lo = srv.submit_generate(PROMPT, 8, model="low")
        for h in highs:
            assert len(h.result(120)) == 40
        np.testing.assert_array_equal(lo.result(120),
                                      oracle(p_lo, PROMPT, 8))
        assert tracing.events("preempted") == []
        assert srv.stats()["preemptions"] == 0
    finally:
        srv.stop(drain=False)
        tracing.reset()


# ---------------------------------------------------------------------------
# automatic defrag
# ---------------------------------------------------------------------------

def test_auto_defrag_keeps_streams_clean():
    _, pa = pair(7)
    srv = port_server(pa, decode_pages=40, len_buckets=(8, 16, 32, 64),
                      max_generate_tokens=PROMPT.size + 60,
                      defrag_threshold=0.1)
    srv.start()
    try:
        # the short streams take LOW pages and finish first; the long
        # stream's pages sit above their holes, so the between-steps
        # trigger packs the pool while it keeps decoding
        shorts = [srv.submit_generate(PROMPT, 8) for _ in range(2)]
        wait_until(lambda: srv.stats()["generates_active"] >= 2,
                   msg="short streams admitted")
        long = srv.submit_generate(PROMPT, 60)
        for h in shorts:
            np.testing.assert_array_equal(h.result(120),
                                          oracle(pa, PROMPT, 8))
        got = long.result(120)
        st = srv.stats()
    finally:
        srv.stop(drain=False)
    assert st["defrags"] >= 1
    np.testing.assert_array_equal(got, oracle(pa, PROMPT, 60))


# ---------------------------------------------------------------------------
# per-tenant upgrade
# ---------------------------------------------------------------------------

def test_upgrading_one_tenant_leaves_the_other_alone():
    _, pa = pair(7)
    _, pb = pair(11)
    _, pb2 = pair(13)
    with port_server(pa) as srv:
        srv.register_model("b", pb)
        before_a = srv.submit_generate(PROMPT, 6).result(120)
        v0 = srv.model_versions()
        srv.swap_model(pb2, model="b")
        v1 = srv.model_versions()
        out_a = srv.submit_generate(PROMPT, 6).result(120)
        out_b = srv.submit_generate(PROMPT, 6, model="b").result(120)
        assert srv.current_model("b") is pb2
        srv.swap_model(pb, version=v0["b"], model="b")    # a rollback
        back = srv.model_versions()
        st = srv.stats()
    assert v1["b"] == v0["b"] + 1 and v1[DEFAULT_MODEL] == v0[DEFAULT_MODEL]
    assert back == v0 and st["reloads"] == 2
    np.testing.assert_array_equal(out_a, before_a)
    np.testing.assert_array_equal(out_a, oracle(pa, PROMPT, 6))
    np.testing.assert_array_equal(out_b, oracle(pb2, PROMPT, 6))


# ---------------------------------------------------------------------------
# fault injection at serving.dispatch
# ---------------------------------------------------------------------------

def test_a_transient_dispatch_fault_is_retried():
    _, pa = pair(7)
    want = oracle(pa, PROMPT, 4)
    with port_server(pa) as srv:
        with fault.inject("serving.dispatch=once") as st:
            got = srv.submit_generate(PROMPT, 4).result(120)
            assert st()["serving.dispatch"]["injected"] == 1
        assert srv.stats()["errors"] == 0
    np.testing.assert_array_equal(got, want)


def test_an_exhausted_dispatch_fault_surfaces(monkeypatch):
    monkeypatch.setenv("MXNET_COMM_RETRY_ATTEMPTS", "2")
    monkeypatch.setenv("MXNET_COMM_RETRY_DELAY", "0.001")
    _, pa = pair(7)
    with port_server(pa) as srv:
        with fault.inject("serving.dispatch=every:1"):
            h = srv.submit_generate(PROMPT, 4)
            with pytest.raises(mx.MXNetError,
                               match="serving.dispatch.*2 attempt"):
                h.result(120)
        assert srv.is_running
        assert len(srv.submit_generate(PROMPT, 2).result(120)) == 2
        # the failed prefill dispatch and its failed request, counted as
        # the reference counts them
        assert srv.stats()["errors"] == 2


def test_only_injected_faults_and_oom_are_transient():
    assert fault.is_transient(fault.FaultInjected("serving.dispatch", 1))
    assert fault.is_transient(torch.OutOfMemoryError("out of memory"))
    assert not fault.is_transient(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert not fault.is_transient(mx.MXNetError("boom"))
    with pytest.raises(mx.MXNetError, match="unknown fault site"):
        fault.parse_spec("serving.dispach=once")


# ---------------------------------------------------------------------------
# telemetry: the reference's metric names and label sets
# ---------------------------------------------------------------------------

def _workload(make, net_a, net_b):
    """Two default streams (one through a retried injected fault), one
    for tenant "b", a throttled shed, a preemption and a defrag."""
    with make(net_a, decode_pages=14, len_buckets=(8, 16, 32, 64),
              max_generate_tokens=PROMPT.size + 40,
              defrag_threshold=0.1) as srv:
        srv.register_model("b", net_b, priority=10, rate_limit=1e-6,
                           burst=2)
        srv.submit_generate(PROMPT, 3).result(120)
        long = srv.submit_generate(PROMPT, 40)
        while not long.tokens():
            time.sleep(0.005)
        srv.submit_generate(PROMPT, 3, model="b").result(120)
        try:
            long.result(120)
        except Exception:   # noqa: BLE001 - the preempted victim
            pass
        srv.submit_generate(PROMPT, 3, model="b").result(120)
        with pytest.raises(Exception, match="admission rate"):
            srv.submit_generate(PROMPT, 3, model="b")
        return srv.stats()


_SAMPLE = re.compile(r"^([a-z_]+?)(_bucket|_sum|_count)?(\{[^}]*\})? ")


def _label_sets(text):
    out = set()
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if not m or line.startswith("#"):
            continue
        name, labels = m.group(1) + (m.group(2) or ""), m.group(3) or ""
        labels = tuple(sorted(kv for kv in re.findall(r'(\w+)="([^"]*)"',
                                                      labels)
                              if kv[0] != "le"))
        if name.startswith(("mxnet_serving", "mxnet_fault", "mxnet_retry",
                            "mxnet_checkpoint")):
            out.add((name, labels))
    return out


def test_prom_text_has_the_reference_metric_names_and_labels():
    ja, pa = pair(7)
    jb, pb = pair(11)
    texts, stats = [], []
    for mod, flt, make, nets in ((telemetry, fault, port_server, (pa, pb)),
                                 (jtelemetry, jfault, jax_server, (ja, jb))):
        was = mod.enabled()
        mod.reset()
        mod.enable()
        try:
            with flt.inject("serving.dispatch=nth:2"):
                stats.append(_workload(make, *nets))
            texts.append(mod.prom_text())
        finally:
            mod.reset()
            if not was:
                mod.disable()
    got, want = (_label_sets(t) for t in texts)
    assert got == want, (sorted(got ^ want))
    assert ("mxnet_serving_preempted_total",
            (("beneficiary", "b"), ("victim", DEFAULT_MODEL))) in got
    assert stats[0]["preemptions"] == stats[1]["preemptions"] == 1
    assert stats[0]["defrags"] >= 1 and stats[1]["defrags"] >= 1
