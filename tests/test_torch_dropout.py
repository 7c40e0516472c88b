"""The port's position-hash dropout held against the JAX package on the
CPU: the hash itself, the ``Dropout`` op, the LayerNorm and flash
attention dropout modes (forward and VJP), the random state and the
training flag, one ``TrainStep`` of a 2-layer ``BERTForPretrainFused``
at dropout 0.1 / 0.1 against the JAX step, and the pinned behaviours
(serving ignores dropout; the attention output is dropped twice).

The reference drops by hashing each element's absolute position under a
u32 seed, so the masks are compared bit for bit given the same seed:
the port's seeds go into the JAX functions as their ``seed`` argument,
or through a patched ``fold_key_seed`` where the JAX op derives its seed
from a PRNG key. The CUDA kernels run only on the card:
tests/test_torch_cuda_kernels.py holds them against these plain
versions there.
"""
import importlib
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo.nlp import bert as jbert
from mxnet_tpu.ops import attention as jattn
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.pallas_kernels import fused_layers as jfl

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, random_state
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import bert_pretrain_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import (BERTForPretrainFused,
                                                 bert_12_768_12)
from mxnet_tpu_torch.gluon.model_zoo.nlp.transformer import \
    TransformerEncoderCell
from mxnet_tpu_torch.gluon.nn import Dropout
from mxnet_tpu_torch.kernels import (flash_attention, flash_attention_bwd,
                                     flash_attention_fwd, fused_layer_norm,
                                     fused_layer_norm_bwd, hash_dropout,
                                     hash_dropout_bwd)
from mxnet_tpu_torch.kernels import dropout as pdrop
from mxnet_tpu_torch.ops import attention as pattn
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.parallel import TrainStep

# the module itself: the package re-exports its function under the name
jfa = importlib.import_module("mxnet_tpu.pallas_kernels.flash_attention")

BF16_RTOL = 2.0 ** -7
SEEDS = [0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _bits_equal(got, want):
    """Bit-identical values (as f32, +0 and -0 apart)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------

# ids at both ends of the u32 range, so the products wrap
IDS = np.array([0, 1, 2, 255, 65535, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 3,
                2 ** 32 - 2, 2 ** 32 - 1, 0x9E3779B9, 123456789],
               dtype=np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_u32_matches_jax_bit_for_bit(seed):
    want = np.asarray(jfa._hash_u32(jnp.asarray(IDS), np.uint32(seed)))
    got = pdrop.hash_u32(torch.from_numpy(IDS.astype(np.int64)), seed)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # the same function over Python ints (the scoped seed stream's)
    assert [pdrop.hash_u32(int(i), seed) for i in IDS] == \
        [int(w) for w in want]
    assert np.array_equal(pdrop.hash_u16(torch.from_numpy(
        IDS.astype(np.int64)), seed).numpy(), want & 0xFFFF)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.25, 0.5, 0.3, 1e-6, 0.99999])
def test_dropout_thresh_matches_jax(p):
    assert pdrop.dropout_thresh(p) == int(jfa.dropout_thresh(p))


@pytest.mark.parametrize("lk", [512, 2 ** 20 + 7])
def test_drop_mask_matches_jax_bit_for_bit(lk):
    """Heads and in-head ids whose q * lk + k wraps past 2**32."""
    rs = np.random.RandomState(lk % 97)
    head = np.array([0, 5, 383, 2 ** 20], np.int64)[:, None, None]
    q = rs.randint(0, 2 ** 20, (1, 24, 1)).astype(np.int64)
    k = rs.randint(0, lk, (1, 1, 40)).astype(np.int64)
    seed, thresh = 0xDEADBEEF, pdrop.dropout_thresh(0.1)
    want = np.asarray(jfa._drop_mask(jnp.asarray(head, jnp.int32),
                                     jnp.asarray(q, jnp.int32),
                                     jnp.asarray(k, jnp.int32), 24, lk,
                                     np.uint32(seed),
                                     jfa.dropout_thresh(0.1)))
    got = pdrop.drop_mask(*(torch.from_numpy(a) for a in (head, q, k)),
                          lk, seed, thresh)
    assert np.array_equal(got.numpy(), want)
    assert 0.85 < want.mean() < 0.95


@pytest.mark.parametrize("block,br,d", [(0, 8, 768), (3, 16, 256),
                                        (1_000_000, 8, 768)])
def test_row_keep_mask_matches_jax_bit_for_bit(block, br, d):
    """Row blocks deep enough that row * d + col wraps past 2**32."""
    seed = 0x12345678
    want = np.asarray(jfl._row_keep_mask(np.array([seed], np.uint32),
                                         jnp.asarray(block, jnp.uint32), br,
                                         d, 0.1))
    got = pdrop.row_keep_mask(br, d, seed, pdrop.dropout_thresh(0.1),
                              row0=block * br)
    assert np.array_equal(got.numpy(), want)
    oracle = np.asarray(jfl._ref_keep_mask((br, d), np.uint32(seed), 0.1))
    assert np.array_equal(pdrop.row_keep_mask(br, d, seed, pdrop
                                              .dropout_thresh(0.1)).numpy(),
                          oracle)


# ---------------------------------------------------------------------------
# the Dropout op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [(), (1,), (0, 2), (-1,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_matches_dropout_op_bit_for_bit(monkeypatch, axes,
                                                     dtype):
    """The plain version against ``dropout_op``'s hash branch, given the
    u32 ``fold_key_seed`` makes of the op's key: the same bits, and the
    scale in the data's dtype (bf16 1 / 0.9 = 1.109375)."""
    monkeypatch.setenv("MXNET_TPU_HASH_DROPOUT", "1")
    rs = np.random.RandomState(len(axes))
    x = rs.randn(4, 6, 40).astype(np.float32)
    jx, tx = _pair(x, dtype)
    key = jax.random.PRNGKey(17 + len(axes))
    seed = int(jfa.fold_key_seed(key))
    want = jnn.dropout_op(key, jx, p=0.1, axes=axes, _training=True)
    got = pdrop.hash_dropout_reference(tx, 0.1, seed, axes)
    assert got.dtype == tx.dtype
    _bits_equal(got, want)
    # the wrapper routes a CPU tensor to the plain version, no launch
    before = hash_dropout.launches
    assert torch.equal(hash_dropout(tx, 0.1, seed, axes), got)
    assert hash_dropout.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_vjp_is_the_same_function_and_saves_no_tensor(dtype):
    """The backward is the forward's function of the output gradient
    (``jax.vjp`` of ``dropout_op`` gives the same), and the autograd node
    keeps the seed, not a mask or an input."""
    rs = np.random.RandomState(5)
    x = rs.randn(3, 50).astype(np.float32)
    g = rs.randn(3, 50).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    seed = 0xCAFEF00D
    leaf = tx.clone().requires_grad_()
    out = hash_dropout(leaf, 0.25, seed)
    assert out.grad_fn.saved_tensors == ()
    out.backward(tg)
    _bits_equal(leaf.grad, hash_dropout_bwd(tg, 0.25, seed))
    _bits_equal(leaf.grad, pdrop.hash_dropout_reference(tg, 0.25, seed))

    def f(a):
        flat = jnp.arange(a.size, dtype=jnp.uint32).reshape(a.shape)
        keep = jfa._hash_u16(flat, np.uint32(seed)) < jfa.dropout_thresh(
            0.25)
        return jnp.where(keep, a * jnp.asarray(1 / 0.75, a.dtype),
                         jnp.zeros_like(a))

    _, vjp = jax.vjp(f, jx)
    _bits_equal(leaf.grad, vjp(jg)[0])


def test_every_kernel_source_is_built():
    """Each ``csrc/*.cu`` is one library of ``_build.SOURCES``: a source
    missing there would be found only when its kernel first launches on
    the card."""
    from mxnet_tpu_torch.kernels import _build

    assert sorted(_build.SOURCES) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert "dropout.cu" in _build.SOURCES
    assert _build.CSRC.joinpath("hash_dropout.cuh").exists()


def test_hash_dropout_checks_rate_and_seed():
    x = torch.ones(4, 8)
    assert hash_dropout(x, 0.0, None) is x
    for p in (-0.1, 1.0, 1.5):
        with pytest.raises(MXNetError, match="must be in"):
            hash_dropout(x, p, 1)
    with pytest.raises(MXNetError, match="requires a seed"):
        hash_dropout(x, 0.1, None)
    with pytest.raises(MXNetError, match="not a u32"):
        hash_dropout(x, 0.1, 2 ** 32)
    with pytest.raises(MXNetError, match="out of range"):
        hash_dropout(x, 0.1, 3, axes=(2,))


# ---------------------------------------------------------------------------
# LayerNorm with dropout (rows 1' and 9)
# ---------------------------------------------------------------------------

LN_DROP_CASES = [("float32", 1e-5, 1e-5), ("bfloat16", BF16_RTOL, 1e-6)]


def _ln_inputs(dtype, seed=3):
    rs = np.random.RandomState(seed)
    x = (1.0 + rs.randn(24, 256)).astype(np.float32)
    r = rs.randn(24, 256).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    b = (0.1 * rs.randn(256)).astype(np.float32)
    dy = rs.randn(24, 256).astype(np.float32)
    return [_pair(a, dtype) for a in (x, r, g, b, dy)]


@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("dtype,rtol,atol", LN_DROP_CASES)
def test_layer_norm_dropout_matches_jax_kernel(with_res, dtype, rtol, atol):
    """``LN(dropout(x) + res)`` forward against the Pallas kernel in
    interpret mode with the same u32 seed (f32: statistics summed in
    another order; bf16: one rounding of the f32 result)."""
    (jx, tx), (jr, tr), (jg, tg), (jb, tb), _ = _ln_inputs(dtype)
    seed = 0x0BADCAFE
    want = jfl.fused_layer_norm(jx, jg, jb, jr if with_res else None,
                                dropout=0.1, seed=np.uint32(seed),
                                interpret=True)
    got = fused_layer_norm(tx, tg, tb, tr if with_res else None,
                           dropout=0.1, seed=seed)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)
    # the mask is really applied: without it the output moves
    plain = fused_layer_norm(tx, tg, tb, tr if with_res else None)
    assert not torch.allclose(plain.float(), got.float())


@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_dropout_vjp_matches_jax_including_dres(with_res, dtype):
    """dx, dres, dgamma and dbeta of the plain backward against
    ``jax.vjp`` of the Pallas kernel (whose backward kernel emits a
    separate dres with dropout), to 2e-5 (f32) or two bf16 ulps of the
    largest magnitude; dx's zero pattern is the mask, bit for bit."""
    (jx, tx), (jr, tr), (jg, tg), (jb, tb), (jdy, tdy) = _ln_inputs(
        dtype, seed=4)
    seed = 77
    res_j = jr if with_res else None

    def f(x, r, g, b):
        return jfl.fused_layer_norm(x, g, b, r, dropout=0.1,
                                    seed=np.uint32(seed), interpret=True)

    if with_res:
        _, vjp = jax.vjp(f, jx, jr, jg, jb)
        jdx, jdres, jdg, jdb = vjp(jdy)
    else:
        _, vjp = jax.vjp(lambda x, g, b: f(x, None, g, b), jx, jg, jb)
        jdx, jdg, jdb = vjp(jdy)
    leaves = [t.clone().requires_grad_() for t in (tx, tg, tb)]
    tres = tr.clone().requires_grad_() if with_res else None
    out = fused_layer_norm(leaves[0], leaves[1], leaves[2], tres,
                           dropout=0.1, seed=seed)
    assert out.grad_fn.saved_tensors is not None
    out.backward(tdy)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -6
    pairs = [(leaves[0].grad, jdx), (leaves[1].grad, jdg),
             (leaves[2].grad, jdb)]
    if with_res:
        pairs.append((tres.grad, jdres))
    for got, want in pairs:
        err = np.abs(_np(got) - _np(want)).max()
        assert err <= tol * np.abs(_np(want)).max(), err
    keep = pdrop.row_keep_mask(24, 256, seed, pdrop.dropout_thresh(0.1))
    assert torch.equal(leaves[0].grad != 0, keep)
    assert np.array_equal(_np(jdx) != 0, keep.numpy())
    # the kernel wrapper's plain route returns dres fourth with a residual
    _, mean, rstd = fused_layer_norm(tx, tg, tb, tr if with_res else None,
                                     dropout=0.1, seed=seed,
                                     return_stats=True)
    outs = fused_layer_norm_bwd(tx, tg, mean, rstd, tdy,
                                tr if with_res else None, 0.1, seed)
    assert len(outs) == (4 if with_res else 3)
    _bits_equal(outs[0], leaves[0].grad)


# ---------------------------------------------------------------------------
# flash attention with dropout (rows 3-8)
# ---------------------------------------------------------------------------

# (b, h, lq, lk, d, causal, layout): which TPU site the JAX side runs
FLASH_DROP_CASES = [
    (2, 2, 128, 128, 32, False, "bhld"),   # rows 3/5, g heads per step
    (2, 2, 128, 128, 32, True, "blhd"),    # rows 4/6, any layout
    (1, 2, 384, 384, 32, False, "bhld"),   # rows 4/7/8, streaming
    (1, 2, 128, 384, 32, False, "blhd"),   # streaming, cross lengths
]


def _flash_inputs(b, h, lq, lk, d, layout, seed):
    rs = np.random.RandomState(seed)
    qs = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
    ks = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
    arrs = [rs.randn(*qs), rs.randn(*ks), rs.randn(*ks), rs.randn(*qs)]
    return [_pair(a.astype(np.float32), "float32") for a in arrs]


@pytest.mark.parametrize("case", FLASH_DROP_CASES)
def test_flash_dropout_matches_jax_kernel_forward_and_vjp(case):
    """Output and dq/dk/dv against the Pallas flash attention in
    interpret mode with the same u32 seed, at the JAX tests' tolerances
    (``tests/test_pallas_kernels.py:180-240``: 1e-5 forward, 2e-4
    gradients; f32 sums in other orders, and the port divides by l(1-p)
    as the TPU kernels do)."""
    b, h, lq, lk, d, causal, layout = case
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _flash_inputs(
        b, h, lq, lk, d, layout, seed=lq + lk)
    seed = 0x5EED0000 + lq
    kw = dict(causal=causal, layout=layout, dropout=0.1)
    out, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(
        a, b_, c, interpret=True, seed=np.uint32(seed), **kw), jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = flash_attention(*leaves, seed=seed, **kw)
    np.testing.assert_allclose(_np(got), _np(out), rtol=1e-5, atol=1e-5)
    assert got.grad_fn.saved_tensors is not None
    got.backward(tg)
    for name, leaf, want in zip("qkv", leaves, vjp(jg)):
        np.testing.assert_allclose(_np(leaf.grad), _np(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"d{name}")
    # the mask is really applied
    assert not torch.allclose(flash_attention(tq, tk, tv, causal=causal,
                                              layout=layout), got.detach())


@pytest.mark.parametrize("d", [32, 64])
def test_flash_dropout_zeros_are_the_mask_bit_for_bit(d):
    """With lk = d and V the identity, O is the dropped, normalised P:
    its zeros are exactly the dropped elements of the reference's
    ``_drop_mask`` (and P > 0 everywhere at these small scores)."""
    b, h = 2, 3
    rs = np.random.RandomState(d)
    q = (0.1 * rs.randn(b, h, 16, d)).astype(np.float32)
    k = (0.1 * rs.randn(b, h, d, d)).astype(np.float32)
    v = np.broadcast_to(np.eye(d, dtype=np.float32), (b, h, d, d)).copy()
    seed = 4242
    out, _ = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                 dropout=0.1, seed=seed)
    shp = (b, h, 16, d)
    head = (jax.lax.broadcasted_iota(jnp.int32, shp, 0) * h
            + jax.lax.broadcasted_iota(jnp.int32, shp, 1))
    keep = np.asarray(jfa._drop_mask(
        head, jax.lax.broadcasted_iota(jnp.int32, shp, 2),
        jax.lax.broadcasted_iota(jnp.int32, shp, 3), 16, d, np.uint32(seed),
        jfa.dropout_thresh(0.1)))
    assert np.array_equal(out.numpy() != 0, keep)


@pytest.mark.parametrize("lq,lk,causal", [(128, 128, False),
                                          (256, 384, True)])
def test_flash_dropout_plain_matches_sdpa_reference_gradients(lq, lk,
                                                              causal):
    """The dense JAX oracle (``_sdpa_reference`` with dropout, the
    multiply-by-1/(1-p) form) agrees with the port's flash plain
    versions to the JAX tests' 2e-4, forward and backward; this holds
    the causal streaming shapes, whose masked Pallas kernels do not
    lower in interpret mode on the CPU."""
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _flash_inputs(
        1, 2, lq, lk, 16, "bhld", seed=9)
    seed = 99
    want_o, vjp = jax.vjp(lambda a, b_, c: jattn._sdpa_reference(
        a, b_, c, None, 0.25, causal, dropout=0.2, seed=np.uint32(seed)),
        jq, jk, jv)
    o, lse = flash_attention_fwd(tq, tk, tv, scale=0.25, causal=causal,
                                 dropout=0.2, seed=seed)
    np.testing.assert_allclose(_np(o), _np(want_o), rtol=1e-5, atol=1e-5)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tg, scale=0.25,
                              causal=causal, dropout=0.2, seed=seed)
    for a, w in zip(got, vjp(jg)):
        np.testing.assert_allclose(_np(a), _np(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
def test_sdp_attention_masked_route_drops_like_the_jax_op(layout):
    """A ``mask`` takes the dense route; in training mode it draws the
    scope's next seed and drops the same elements as the JAX op's dense
    route (``_sdpa_reference``) for that seed; in predict mode it does
    not drop."""
    rs = np.random.RandomState(2)
    shp = (2, 16, 2, 8) if layout == "blhd" else (2, 2, 16, 8)
    q, k, v = (rs.randn(*shp).astype(np.float32) for _ in range(3))
    mask = (rs.rand(2, 1, 1, 16) > 0.3).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    j = [jnp.asarray(a) for a in (q, k, v, mask)]
    with autograd.train_mode(), random_state.scoped_seed(6):
        got = pattn.sdp_attention(*t, scale=0.35, layout=layout,
                                  dropout=0.1)
    want = jattn._sdpa_reference(*j, 0.35, False, layout=layout,
                                 dropout=0.1,
                                 seed=np.uint32(pdrop.hash_u32(0, 6)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    undropped = pattn.sdp_attention(*t, scale=0.35, layout=layout,
                                    dropout=0.1)
    np.testing.assert_allclose(_np(undropped), _np(jattn._sdpa_reference(
        *j, 0.35, False, layout=layout)), rtol=1e-5, atol=1e-5)
    assert not np.allclose(_np(got), _np(undropped))


# ---------------------------------------------------------------------------
# random state and the training flag
# ---------------------------------------------------------------------------

def test_seed_makes_the_streams_reproducible_and_per_device():
    mx.random.seed(11)
    a = [random_state.next_seed() for _ in range(4)]
    b = random_state.next_seed("cuda:0")
    mx.random.seed(11)
    assert [random_state.next_seed() for _ in range(4)] == a
    assert random_state.next_seed(torch.device("cuda")) == b
    assert b not in a and len(set(a)) == 4
    assert all(0 <= s < 2 ** 32 for s in a + [b])
    mx.random.seed(12)
    assert random_state.next_seed() != a[0]
    # one device reseeded alone
    mx.random.seed(5, ctx="cpu")
    c = random_state.next_seed()
    mx.random.seed(5, ctx=mx.cpu())
    assert random_state.next_seed() == c


def test_scoped_seed_draws_are_a_function_of_position_and_step_seed():
    mx.random.seed(3)
    with random_state.preserved_stream():
        outside = random_state.next_seed()
    with random_state.scoped_seed(1234):
        draws = [random_state.next_seed() for _ in range(5)]
        with random_state.scoped_seed(99):
            inner = random_state.next_seed()
        after = random_state.next_seed()
    assert draws == [pdrop.hash_u32(k, 1234) for k in range(5)]
    assert inner == pdrop.hash_u32(0, 99)
    assert after == pdrop.hash_u32(5, 1234)
    # the scope did not touch the stream; preserved_stream rolled it back
    assert random_state.next_seed() == outside


def test_training_flag_scopes_and_is_per_thread():
    assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            autograd.is_training()))
        t.start()
        t.join()
        assert seen == [False]
        with autograd.predict_mode():
            assert not autograd.is_training()
        assert autograd.is_training()
    assert not autograd.is_training()
    assert autograd.set_training(True) is False
    assert autograd.set_training(False) is True


def test_dropout_layer_and_op_apply_only_in_training_or_always():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    layer = Dropout(0.5)
    assert layer(x) is x
    assert pnn.dropout(x, p=0.5) is x
    with autograd.train_mode(), random_state.scoped_seed(8):
        y = layer(x)
        z = pnn.dropout(x, p=0.5)
    assert torch.equal(y, pdrop.hash_dropout_reference(
        x, 0.5, pdrop.hash_u32(0, 8)))
    assert torch.equal(z, pdrop.hash_dropout_reference(
        x, 0.5, pdrop.hash_u32(1, 8)))
    with random_state.scoped_seed(8):
        always = pnn.dropout(x, p=0.5, mode="always", axes=(0,))
    assert torch.equal(always, pdrop.hash_dropout_reference(
        x, 0.5, pdrop.hash_u32(0, 8), axes=(0,)))
    with pytest.raises(MXNetError, match="mode"):
        pnn.dropout(x, p=0.5, mode="sometimes")


# ---------------------------------------------------------------------------
# the pinned behaviours
# ---------------------------------------------------------------------------

def test_attention_output_is_dropped_twice_as_in_the_reference():
    """The post-LN cell drops the attention block's output in the block
    (site 2) and again in the fused add+norm (site 3), as the JAX cell
    does on its fused route (``transformer.py:86-92``); GluonNLP drops it
    once. The cell equals that composition, seeds in call order."""
    torch.manual_seed(0)
    cell = TransformerEncoderCell(32, 64, 4, dropout=0.1,
                                  activation="gelu", attn_dropout=0.1)
    cell.initialize(ctx=mx.cpu())
    with torch.no_grad():
        for p in cell.parameters():
            p.normal_(0.0, 0.3)
    x = torch.randn(2, 16, 32)
    s = [pdrop.hash_u32(k, 555) for k in range(4)]
    with autograd.train_mode(), random_state.scoped_seed(555):
        got = cell(x)
    att = cell.attention
    qkv = att.qkv_proj(x)
    q, k, v = (t.view(2, 16, 4, 8) for t in qkv.split(32, dim=-1))
    h = flash_attention(q, k, v, layout="blhd", dropout=0.1, seed=s[0])
    h = att.out_proj(h.reshape(2, 16, 32))
    h = pdrop.hash_dropout_reference(h, 0.1, s[1])            # site 2
    y = fused_layer_norm(h, cell.ln1.gamma.tensor, cell.ln1.beta.tensor, x,
                         dropout=0.1, seed=s[2])               # site 3
    f = pdrop.hash_dropout_reference(cell.ffn.ffn2(cell.ffn.ffn1(y)), 0.1,
                                     s[3])
    want = fused_layer_norm(f, cell.ln2.gamma.tensor, cell.ln2.beta.tensor,
                            y)
    assert torch.equal(got, want)


CFG = dict(vocab_size=512, max_length=128, num_layers=2, units=64,
           hidden_size=128, num_heads=4, chunk=128)


def test_server_answers_ignore_dropout(monkeypatch):
    """A model built with dropout 0.1 / 0.1 serves exactly what the same
    weights serve at dropout 0: ``_dispatch`` (and the warm-up) run in
    predict mode. The training flag is made to default to on in every
    thread here, so only the server's own predict mode keeps the
    dropout sites off."""
    monkeypatch.setattr(autograd, "is_training", lambda: getattr(
        autograd._state, "training", True))
    cfg = {k: v for k, v in CFG.items() if k != "chunk"}
    nets = [bert_12_768_12(ctx=mx.cpu(), dropout=rate, attn_dropout=rate,
                           generator=torch.Generator().manual_seed(0),
                           **cfg) for rate in (0.1, 0.0)]
    nets[0].load_state_dict(nets[1].state_dict())
    rs = np.random.RandomState(0)
    samples = [rs.randint(1, 512, size=n).astype(np.float32)
               for n in (30, 64, 7)]
    answers = []
    for net in nets:
        with mx.serving.Server(net, ctx=mx.cpu(), shape_buckets=[(64,)],
                               batch_buckets=(1, 4)) as srv:
            futs = [srv.submit(s) for s in samples]
            answers.append([f.result(60) for f in futs])
    for a, b in zip(*answers):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    # the same net in training mode outside the server does drop
    tok = torch.from_numpy(np.resize(samples[0], (1, 64)))
    with torch.no_grad(), autograd.train_mode(), \
            random_state.scoped_seed(1):
        trained = nets[0](tok)
    assert not torch.equal(trained[0], nets[1](tok)[0])


# ---------------------------------------------------------------------------
# one TrainStep at dropout 0.1 / 0.1 against the JAX step
# ---------------------------------------------------------------------------

DCFG = dict(CFG, dropout=0.1, attn_dropout=0.1)
LR = 1e-3


def _draw(jnet, seed):
    rs = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        shape = p.shape
        if name.endswith("gamma"):
            arr = 1.0 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "bias")):
            arr = 0.1 * rs.randn(*shape)
        else:
            arr = rs.randn(*shape) / np.sqrt(shape[-1])
        arr = arr.astype(np.float32)
        p.set_data(jmx.nd.array(arr))
        named[name] = arr
    return named


def _batch():
    rs = np.random.RandomState(2)
    return (rs.randint(0, 512, (4, 128)).astype(np.int32),
            rs.randint(0, 512, (4, 128)).astype(np.int32))


def test_trainstep_at_dropout_matches_the_jax_step(monkeypatch):
    """One f32 Adam step of a 2-layer BERTForPretrainFused at dropout
    0.1 / 0.1, port against the JAX TrainStep from the same weights and
    batch, with the JAX dropout sites (``MXNET_PALLAS_FUSED=1``: the hash
    everywhere) handed, in call order, the seeds the port's
    ``scoped_seed`` gives: 1 embedding + 4 per layer. The JAX step bakes
    them in at trace time, so one fresh JAX step is compared, and each op
    call traces its own executable here (the eager op cache would hand
    every call of an op the first call's baked seed). The loss
    agrees to 1e-5 relative and each parameter's delta to 1e-4 of its
    norm (f32 sums in other orders; the key third of each QKV bias, whose
    true gradient is 0, held apart as in test_torch_bert_train.py)."""
    monkeypatch.setenv("MXNET_PALLAS_FUSED", "1")
    n_sites = 1 + 4 * DCFG["num_layers"]
    mx.random.seed(2024)
    with random_state.preserved_stream():
        step_seed = random_state.next_seed(mx.cpu())
    seeds = [pdrop.hash_u32(k, step_seed) for k in range(n_sites)]
    calls = []

    def fold(rng):
        calls.append(rng)
        return np.uint32(seeds[(len(calls) - 1) % n_sites])

    monkeypatch.setattr(jfa, "fold_key_seed", fold)
    monkeypatch.setattr(
        jreg, "_eager_executable",
        lambda opname, attr_items, n_tensors, has_rng, platform, *a, **k:
        (jreg._build_eager(opname, attr_items, has_rng), False))
    jnet = jbert.BERTForPretrainFused(**DCFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    named = _draw(jnet, 31)
    assert not calls                      # predict mode draws no seed
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jpar.TrainStep(jnet, lambda outs, *a: outs, "adam", mesh=mesh,
                           loss_only=True,
                           optimizer_params={"learning_rate": LR})
    tok, lab = _batch()
    jloss = float(jstep((jmx.nd.array(tok), jmx.nd.array(lab)),
                        ())[0].asnumpy())
    assert len(calls) == n_sites
    jparams = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}

    net = BERTForPretrainFused(ctx=mx.cpu(), **DCFG)
    net.load_state_dict(bert_pretrain_params_from_reference(named))
    drawn = []
    real = random_state.next_seed
    monkeypatch.setattr(random_state, "next_seed",
                        lambda *a: drawn.append(real(*a)) or drawn[-1])
    step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                     optimizer_params={"learning_rate": LR})
    ploss = float(step((tok, lab), ())[0])
    assert drawn == [step_seed] + seeds
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)

    # the step at dropout 0 is another function: dropout really acted
    assert abs(ploss - _loss_at_dropout_zero(named, tok, lab)) > 1e-4
    sd0 = bert_pretrain_params_from_reference(named)
    got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    want = bert_pretrain_params_from_reference(jparams)
    units = DCFG["units"]
    for key, w0 in sd0.items():
        dj = want[key].numpy() - w0.numpy()
        dp = got[key] - w0.numpy()
        if key.endswith("qkv_proj.bias"):
            k_part = slice(units, 2 * units)
            assert max(np.abs(dj[k_part]).max(),
                       np.abs(dp[k_part]).max()) <= LR * 1.0001
            dj, dp = np.delete(dj, k_part), np.delete(dp, k_part)
        norm = float(np.linalg.norm(dj))
        if norm == 0.0:
            assert float(np.linalg.norm(dp)) == 0.0, key
            continue
        assert float(np.linalg.norm(dp - dj)) / norm < 1e-4, key


def _loss_at_dropout_zero(named, tok, lab):
    net = BERTForPretrainFused(ctx=mx.cpu(), **dict(DCFG, dropout=0.0,
                                                    attn_dropout=0.0))
    net.load_state_dict(bert_pretrain_params_from_reference(named))
    with torch.no_grad():
        return float(net(torch.from_numpy(tok),
                         torch.from_numpy(lab)).mean())


def test_trainstep_forward_draws_one_seed_per_site_in_order():
    """A step draws the step seed from the device's stream, then one
    seed per applied dropout site: at rates of 0 (or attention dropout
    alone) fewer sites draw, as the reference's ``rng_gate`` does."""
    for dropout, attn, per_layer in ((0.1, 0.1, 4), (0.1, 0.0, 3),
                                     (0.0, 0.1, 1), (0.0, 0.0, 0)):
        net = BERTForPretrainFused(ctx=mx.cpu(), **dict(
            CFG, num_layers=1, dropout=dropout, attn_dropout=attn))
        step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True)
        drawn = []
        real = random_state.next_seed
        random_state.next_seed = lambda *a: drawn.append(1) or real(*a)
        try:
            tok, lab = _batch()
            step((tok[:1], lab[:1]), ())
        finally:
            random_state.next_seed = real
        assert len(drawn) == 1 + per_layer + int(dropout > 0), (dropout,
                                                                 attn)
