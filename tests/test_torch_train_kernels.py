"""The pretraining path's backward and optimizer modules of the port held
against the JAX package on the CPU: the flash attention backward, the
LayerNorm (± residual) and bias+GELU backward, the Adam sweep and the
fused projection + cross-entropy head.

Each plain PyTorch version is compared with the JAX Pallas kernel run in
interpret mode (its ``jax.vjp``, or ``packed_apply(..., interpret=True)``
for the sweep) on the same seeded numpy inputs, and each differentiable
wrapper's autograd gradient with the plain backward. The CUDA kernels
run only on the card: tests/test_torch_cuda_kernels.py holds them against
these plain versions there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import fused_loss as jloss
from mxnet_tpu.optimizer import multi_tensor as jmt
from mxnet_tpu.pallas_kernels import fused_layers as jfl
from mxnet_tpu.pallas_kernels.flash_attention import \
    flash_attention as jax_flash

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import (adam_sweep_reference, flash_attention,
                                     flash_attention_bwd,
                                     flash_attention_bwd_reference,
                                     flash_attention_fwd, fused_adam_sweep,
                                     fused_bias_gelu, fused_bias_gelu_bwd,
                                     fused_bias_gelu_bwd_reference,
                                     fused_layer_norm, fused_layer_norm_bwd,
                                     fused_layer_norm_bwd_reference,
                                     fused_layer_norm_reference)
from mxnet_tpu_torch.ops.fused_loss import softmax_ce_head
from mxnet_tpu_torch.optimizer import multi_tensor as pmt

# bf16 keeps 8 significant bits: one rounding of the same f32 value is
# at most 2**-7 of its magnitude apart
BF16_RTOL = 2.0 ** -7


def _np(x):
    """A torch or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """The same numpy values as a (jax, torch) pair in ``dtype``."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _close_to_max(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), (what, err)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

# (b, h, lq, lk, d, causal, layout): which TPU site the JAX side runs
FLASH_BWD_CASES = [
    (2, 2, 128, 128, 32, False, "bhld"),   # row 5, fused, g heads (:914)
    (2, 2, 128, 128, 32, True, "blhd"),    # row 6, fused, any layout (:937)
    (1, 2, 384, 384, 32, True, "bhld"),    # rows 7-8, streaming (:959/:977)
    (1, 2, 128, 384, 32, False, "blhd"),   # rows 7-8, cross lengths
]


def _flash_inputs(b, h, lq, lk, d, layout, seed, dtype="float32"):
    rs = np.random.RandomState(seed)
    qs = (b, h, lq, d) if layout == "bhld" else (b, lq, h, d)
    ks = (b, h, lk, d) if layout == "bhld" else (b, lk, h, d)
    arrs = [rs.randn(*qs), rs.randn(*ks), rs.randn(*ks), rs.randn(*qs)]
    return [_pair(a.astype(np.float32), dtype) for a in arrs]


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_plain_matches_jax_vjp(case):
    """dq, dk, dv of the plain backward against ``jax.vjp`` of the Pallas
    flash attention in interpret mode, at the JAX tests' 2e-4 (f32: the
    same products summed in other orders)."""
    b, h, lq, lk, d, causal, layout = case
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _flash_inputs(
        b, h, lq, lk, d, layout, seed=lq + lk + causal)
    out, lse = flash_attention_fwd(tq, tk, tv, causal=causal, layout=layout)
    got = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg,
                                        causal=causal, layout=layout)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(
        a, b_, c, causal=causal, interpret=True, layout=layout), jq, jk, jv)
    for name, g, want in zip("qkv", got, vjp(jg)):
        assert g.shape == (tq, tk, tv)["qkv".index(name)].shape
        np.testing.assert_allclose(_np(g), _np(want), rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")
    # the wrapper routes a CPU tensor to the plain version, no launch
    before = flash_attention_bwd.launches
    again = flash_attention_bwd(tq, tk, tv, out, lse, tg, causal=causal,
                                layout=layout)
    assert flash_attention_bwd.launches == before
    assert all(torch.equal(a, c) for a, c in zip(again, got))


def test_flash_bwd_bf16_plain_matches_jax_vjp():
    """bf16: P rounds to bf16 before P^T.dO and dS before dS.K / dS^T.Q
    on both sides, then each gradient rounds once more; values that fall
    near a rounding boundary may land one way or the other, so the
    gradients agree to two bf16 ulps of their largest magnitude."""
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = _flash_inputs(
        2, 2, 128, 128, 32, "bhld", seed=3, dtype="bfloat16")
    out, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    got = flash_attention_bwd_reference(tq, tk, tv, out, lse, tg,
                                        causal=True)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(
        a, b_, c, causal=True, interpret=True), jq, jk, jv)
    for name, g, want in zip("qkv", got, vjp(jg)):
        assert g.dtype == torch.bfloat16
        _close_to_max(g, want, 2.0 ** -6, f"d{name}")


def test_flash_autograd_through_fused_qkv_views_matches_jax():
    """The heads as MultiHeadAttention hands them over: (B, L, H, D)
    views into one (B, L, 3*H*D) projection output. The port's
    differentiable flash_attention gives the gradient of the whole
    projection output; the JAX vjp of the same views gives the same."""
    b, l, h, d = 2, 128, 2, 32
    rs = np.random.RandomState(11)
    qkv = rs.randn(b, l, 3 * h * d).astype(np.float32)
    g = rs.randn(b, l, h, d).astype(np.float32)
    t_qkv = torch.from_numpy(qkv).requires_grad_()
    q, k, v = (t.view(b, l, h, d) for t in t_qkv.split(h * d, dim=-1))
    assert q.stride(1) == 3 * h * d
    out = flash_attention(q, k, v, layout="blhd")
    out.backward(torch.from_numpy(g))

    def jf(x):
        jq, jk, jv = (t.reshape(b, l, h, d)
                      for t in jnp.split(x, 3, axis=-1))
        return jax_flash(jq, jk, jv, interpret=True, layout="blhd")

    want_out, vjp = jax.vjp(jf, jnp.asarray(qkv))
    np.testing.assert_allclose(_np(out), _np(want_out), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_np(t_qkv.grad), _np(vjp(jnp.asarray(g))[0]),
                               rtol=2e-4, atol=2e-4)


def test_flash_autograd_equals_plain_backward_and_serving_launches_none():
    """With grad enabled the wrapper's backward is flash_attention_bwd;
    under inference_mode nothing is saved for a backward."""
    (_, tq), (_, tk), (_, tv), (_, tg) = _flash_inputs(
        1, 2, 70, 90, 16, "bhld", seed=5)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=True)
    out.backward(tg)
    o, lse = flash_attention_fwd(tq, tk, tv, causal=True)
    want = flash_attention_bwd(tq, tk, tv, o, lse, tg, causal=True)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    with torch.inference_mode():
        assert flash_attention(*leaves, causal=True).grad_fn is None


def test_flash_bwd_rows_with_no_visible_key_give_zero_gradients():
    """A negative causal offset leaves the first query rows no key: their
    lse is -1e30 and P is 0 there, so dq is 0 and they add nothing to dk,
    dv."""
    from mxnet_tpu_torch.kernels.flash import _bwd_reference, _reference

    (_, tq), (_, tk), (_, tv), (_, tg) = _flash_inputs(
        1, 2, 40, 40, 16, "bhld", seed=6)
    o, lse = _reference(tq, tk, tv, 0.25, True, -10, "bhld")
    dq, dk, dv = _bwd_reference(tq, tk, tv, o, lse, tg, 0.25, True, -10,
                                "bhld")
    assert torch.count_nonzero(dq[:, :, :10]) == 0
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    # the last 10 keys are visible to no row at all
    assert torch.count_nonzero(dk[:, :, 30:]) == 0
    assert torch.count_nonzero(dv[:, :, 30:]) == 0


# ---------------------------------------------------------------------------
# LayerNorm (+ residual) backward
# ---------------------------------------------------------------------------

LN_BWD_CASES = [
    # (x dtype, gamma dtype, rtol, atol). f32: the row means and the
    # column sums are taken in another order. bf16: dx, dgamma and dbeta
    # are each one rounding of an f32 value (dgamma, dbeta sum over only
    # 16 rows, so their f32 differences stay far below a bf16 ulp)
    ("float32", "float32", 1e-5, 1e-5),
    ("bfloat16", "bfloat16", BF16_RTOL, 1e-5),
    ("bfloat16", "float32", BF16_RTOL, 1e-5),
]


@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("xdt,gdt,rtol,atol", LN_BWD_CASES)
def test_layer_norm_bwd_plain_matches_jax_vjp(with_res, xdt, gdt, rtol,
                                              atol):
    rs = np.random.RandomState(21)
    x = (3.0 + rs.randn(16, 256)).astype(np.float32)
    r = rs.randn(16, 256).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(256)).astype(np.float32)
    b = (0.1 * rs.randn(256)).astype(np.float32)
    dy = rs.randn(16, 256).astype(np.float32)
    jx, tx = _pair(x, xdt)
    jr, tr = _pair(r, xdt)
    jg, tg = _pair(g, gdt)
    jb, tb = _pair(b, gdt)
    jdy, tdy = _pair(dy, xdt)
    res_t = tr if with_res else None
    _, mean, rstd = fused_layer_norm_reference(tx, tg, tb, res_t, eps=1e-5,
                                               return_stats=True)
    dx, dgamma, dbeta = fused_layer_norm_bwd_reference(tx, tg, mean, rstd,
                                                       tdy, res_t)
    assert dx.dtype == tx.dtype and dgamma.dtype == tg.dtype
    if with_res:
        _, vjp = jax.vjp(lambda a, c, e, f: jfl.fused_layer_norm(
            a, e, f, c, eps=1e-5, interpret=True), jx, jr, jg, jb)
        jdx, jdr, jdg, jdb = vjp(jdy)
        np.testing.assert_allclose(_np(dx), _np(jdr), rtol=rtol, atol=atol)
    else:
        _, vjp = jax.vjp(lambda a, e, f: jfl.fused_layer_norm(
            a, e, f, eps=1e-5, interpret=True), jx, jg, jb)
        jdx, jdg, jdb = vjp(jdy)
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(dgamma), _np(jdg), rtol=rtol,
                               atol=atol * 16)
    np.testing.assert_allclose(_np(dbeta), _np(jdb), rtol=rtol,
                               atol=atol * 16)


def test_layer_norm_autograd_equals_plain_backward():
    rs = np.random.RandomState(22)
    x, r, dy = (torch.from_numpy(rs.randn(3, 5, 100).astype(np.float32))
                for _ in range(3))
    g = torch.from_numpy((1 + 0.1 * rs.randn(100)).astype(np.float32))
    b = torch.from_numpy((0.1 * rs.randn(100)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, r, g, b)]
    out = fused_layer_norm(leaves[0], leaves[2], leaves[3], leaves[1])
    assert out.grad_fn is not None
    out.backward(dy)
    _, mean, rstd = fused_layer_norm_reference(x, g, b, r,
                                               return_stats=True)
    before = fused_layer_norm_bwd.launches
    dx, dgamma, dbeta = fused_layer_norm_bwd(x, g, mean, rstd, dy, r)
    assert fused_layer_norm_bwd.launches == before     # CPU: plain version
    for leaf, want in zip(leaves, (dx, dx, dgamma, dbeta)):
        assert torch.equal(leaf.grad, want)
    with torch.inference_mode():
        assert fused_layer_norm(*leaves[:1], *leaves[2:]).grad_fn is None


# ---------------------------------------------------------------------------
# bias + GELU backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt,bdt,rtol,atol", [
    # f32: erf and exp of the same f32 argument in two libraries, and the
    # bias sum over 16 rows in another order
    ("float32", "float32", 1e-5, 1e-5),
    # bf16: each of dx and dbias is one rounding of an f32 value
    ("bfloat16", "bfloat16", BF16_RTOL, 1e-5),
    ("bfloat16", "float32", BF16_RTOL, 1e-5),
])
def test_bias_gelu_bwd_plain_matches_jax_vjp(xdt, bdt, rtol, atol):
    rs = np.random.RandomState(31)
    x = (2.0 * rs.randn(16, 384)).astype(np.float32)
    b = rs.randn(384).astype(np.float32)
    dy = rs.randn(16, 384).astype(np.float32)
    jx, tx = _pair(x, xdt)
    jb, tb = _pair(b, bdt)
    jdy, tdy = _pair(dy, xdt)
    dx, db = fused_bias_gelu_bwd_reference(tx, tb, tdy)
    assert dx.dtype == tx.dtype and db.dtype == tb.dtype
    _, vjp = jax.vjp(lambda a, c: jfl.fused_bias_gelu(a, c, interpret=True),
                     jx, jb)
    jdx, jdb = vjp(jdy)
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(db), _np(jdb), rtol=rtol, atol=atol * 16)
    # autograd through the wrapper lands on the same gradients
    lx, lb = tx.clone().requires_grad_(), tb.clone().requires_grad_()
    fused_bias_gelu(lx, lb).backward(tdy)
    before = fused_bias_gelu_bwd.launches
    assert torch.equal(lx.grad, fused_bias_gelu_bwd(tx, tb, tdy)[0])
    assert fused_bias_gelu_bwd.launches == before
    assert torch.equal(lb.grad, db)


# ---------------------------------------------------------------------------
# the Adam sweep
# ---------------------------------------------------------------------------

ADAM_STATIC = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
               "clip_gradient": None}
ADAM_SHAPES = [(4, 5), (7,), (2, 3, 2), (33, 17)]
LRS = [0.1, 0.05, 0.02, 0.01]
WDS = [0.0, 0.01, 0.001, 0.0]


def _adam_members(rs, low_dtype=None):
    ws = [rs.randn(*s).astype(np.float32) for s in ADAM_SHAPES]
    gs = [rs.randn(*s).astype(np.float32) for s in ADAM_SHAPES]
    ms = [0.1 * rs.randn(*s).astype(np.float32) for s in ADAM_SHAPES]
    vs = [rs.rand(*s).astype(np.float32) for s in ADAM_SHAPES]
    if low_dtype is not None:
        # a bf16-mp bucket: bf16 grads, f32 masters and moments
        gs = [np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                         .astype(jnp.float32)) for g in gs]
    return ws, gs, ms, vs


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("mp", [False, True])
def test_adam_sweep_plain_matches_jax_packed_apply(mp, clip):
    """The plain sweep against ``packed_apply("adam", interpret=True)``,
    the Pallas sweep in interpret mode, at the JAX tests' rtol 1e-6 /
    atol 1e-7 (FMA contraction in XLA against one op per step here)."""
    rs = np.random.RandomState(41 + mp)
    ws, gs, ms, vs = _adam_members(rs, jnp.bfloat16 if mp else None)
    static = dict(ADAM_STATIC, clip_gradient=clip)
    ins = {"w": [jnp.asarray(a) for a in ws],
           "g": [jnp.asarray(a) for a in gs],
           "mean": [jnp.asarray(a) for a in ms],
           "var": [jnp.asarray(a) for a in vs]}
    want = jmt.packed_apply("adam", static, ADAM_SHAPES, ins,
                            {"lr": LRS, "wd": WDS}, 0.5,
                            low_dtype=jnp.bfloat16 if mp else None,
                            platform="cpu", interpret=True)
    t_ins = {"w": [torch.from_numpy(a.copy()) for a in ws],
             "g": [torch.from_numpy(a.copy()) for a in gs],
             "mean": [torch.from_numpy(a.copy()) for a in ms],
             "var": [torch.from_numpy(a.copy()) for a in vs]}
    if mp:
        t_ins["g"] = [g.to(torch.bfloat16) for g in t_ins["g"]]
    low = [torch.zeros(s, dtype=torch.bfloat16) for s in ADAM_SHAPES] \
        if mp else None
    before = fused_adam_sweep.launches
    got = pmt.packed_apply("adam", tuple(sorted(static.items())), t_ins,
                           {"lr": LRS, "wd": WDS}, 0.5, low=low)
    assert fused_adam_sweep.launches == before        # CPU: plain version
    for role in ("w", "mean", "var"):
        for a, b in zip(got[role], want[role]):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                       err_msg=role)
    if mp:
        for a, b in zip(got["w_low"], want["w_low"]):
            assert a.dtype == torch.bfloat16
            # the same f32 master up to 1e-6, rounded once to bf16
            np.testing.assert_allclose(_np(a), _np(b), rtol=BF16_RTOL,
                                       atol=1e-7)


def test_adam_sweep_updates_in_place_and_keeps_dtypes():
    """A bf16 bucket without multi-precision keeps bf16 weights and
    moments, computes in f32 and rounds once, as ``_adam_elem`` does."""
    rs = np.random.RandomState(43)
    w, g, m = (torch.from_numpy(rs.randn(64).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    v = torch.from_numpy(rs.rand(64).astype(np.float32)).to(torch.bfloat16)
    w0, m0, v0 = w.clone(), m.clone(), v.clone()
    ptr = w.data_ptr()
    adam_sweep_reference([w], [g], [m], [v], None, [0.01], [0.0],
                         beta1=0.9, beta2=0.999, epsilon=1e-8,
                         rescale_grad=1.0)
    assert w.data_ptr() == ptr and w.dtype == torch.bfloat16
    g32 = g.float()
    m32 = 0.9 * m0.float() + (1 - 0.9) * g32
    v32 = 0.999 * v0.float() + (1 - 0.999) * (g32 * g32)
    w32 = w0.float() - 0.01 * m32 / (torch.sqrt(v32) + 1e-8)
    assert torch.equal(w, w32.to(torch.bfloat16))
    assert torch.equal(m, m32.to(torch.bfloat16))
    assert torch.equal(v, v32.to(torch.bfloat16))


def test_bias_corrected_lr_matches_the_jax_step():
    """In the fused step the JAX optimizer computes the bias-corrected lr
    from the traced int32 t and f32 lr (``step.py:919-920``), in f64 as
    the package runs with ``jax_enable_x64``; the port computes it in
    Python doubles. Rounded to f32, as the sweep reads it, the two are
    equal over t = 1..50."""
    import mxnet_tpu as jmx

    jopt = jmx.optimizer.create("adam", learning_rate=1e-4)
    popt = mx.optimizer.create("adam", learning_rate=1e-4)

    @jax.jit
    def jlr(t, lr):
        with jopt.dynamic(t, lr):
            return jmt.collect_scalars(jopt, "adam", [0])["lr"][0]

    for t in range(1, 51):
        want = np.float32(jlr(np.int32(t), np.float32(1e-4)))
        with popt.dynamic(np.int32(t), np.float32(1e-4)):
            got = np.float32(pmt.collect_scalars(popt, "adam", [0])["lr"][0])
        assert got == want, t


# ---------------------------------------------------------------------------
# the fused projection + CE head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,chunk", [(700, 256), (512, 128)])
def test_softmax_ce_head_matches_jax_op(v, chunk):
    """Loss and the gradients of hidden, weight and bias against the JAX
    op, with a padded vocabulary (700 over chunks of 256) and an unpadded
    one; f32, the same chunked arithmetic summed in other orders."""
    rs = np.random.RandomState(51)
    n, d = 48, 24
    h = (0.5 * rs.randn(n, d)).astype(np.float32)
    w = (0.1 * rs.randn(v, d)).astype(np.float32)
    b = (0.1 * rs.randn(v)).astype(np.float32)
    lab = rs.randint(0, v, (n,)).astype(np.int32)
    gl = rs.rand(n).astype(np.float32)

    jout, vjp = jax.vjp(lambda a, c, e: jloss.softmax_ce_head(
        a, c, e, jnp.asarray(lab), chunk=chunk), jnp.asarray(h),
        jnp.asarray(w), jnp.asarray(b))
    jdh, jdw, jdb = vjp(jnp.asarray(gl))
    th, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (h, w, b))
    out = softmax_ce_head(th, tw, tb, torch.from_numpy(lab), chunk=chunk)
    assert out.shape == (n,) and out.dtype == torch.float32
    out.backward(torch.from_numpy(gl))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    for got, want, name in ((th.grad, jdh, "h"), (tw.grad, jdw, "w"),
                            (tb.grad, jdb, "b")):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # against the materialised logits too
    logits = torch.from_numpy(h) @ torch.from_numpy(w).T \
        + torch.from_numpy(b)
    ce = torch.nn.functional.cross_entropy(logits,
                                           torch.from_numpy(lab).long(),
                                           reduction="none")
    np.testing.assert_allclose(_np(out), _np(ce), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,chunk", [(512, 128), (700, 256)])
def test_softmax_ce_head_without_bias_matches_jax_op(v, chunk):
    """``bias=None``: where the chunk divides the vocabulary the head runs
    a bias-free node, as the reference's ``_fused_ce_nobias``: the
    autograd graph holds no vocab-sized bias tensor and no bias input;
    with a padded vocabulary (700 over chunks of 256) a zero bias masks
    the padding rows, as the reference's fallback. Loss and the hidden
    and weight gradients against the JAX op at the biased test's rtol /
    atol 1e-5 (f32, the same chunked arithmetic summed in other
    orders)."""
    rs = np.random.RandomState(53)
    n, d = 40, 16
    h = (0.5 * rs.randn(n, d)).astype(np.float32)
    w = (0.1 * rs.randn(v, d)).astype(np.float32)
    lab = rs.randint(0, v, (n,)).astype(np.int32)
    gl = rs.rand(n).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, c: jloss.softmax_ce_head(
        a, c, None, jnp.asarray(lab), chunk=chunk), jnp.asarray(h),
        jnp.asarray(w))
    jdh, jdw = vjp(jnp.asarray(gl))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    out = softmax_ce_head(th, tw, None, torch.from_numpy(lab), chunk=chunk)
    node = out.grad_fn
    while type(node).__name__ != "_SoftmaxCEHeadBackward":
        node = node.next_functions[0][0]
    saved = [t for t in node.saved_tensors if t is not None]
    has_bias = any(t.dim() == 1 and t.shape[0] >= v for t in saved)
    assert has_bias == (v % chunk != 0), [tuple(t.shape) for t in saved]
    # no bias gradient flows anywhere: no bias input, or a constant one
    assert node.next_functions[2][0] is None
    out.backward(torch.from_numpy(gl))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
    for got, want, name in ((th.grad, jdh, "h"), (tw.grad, jdw, "w")):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_softmax_ce_head_bf16_close_to_f32():
    """bf16 hidden and weight with f32 chunk logits: within the JAX
    test's 0.05 of the f32 loss (``tests/test_fused_ce_head.py:38-51``)."""
    rs = np.random.RandomState(52)
    h = torch.from_numpy((0.5 * rs.randn(32, 16)).astype(np.float32))
    w = torch.from_numpy((0.1 * rs.randn(512, 16)).astype(np.float32))
    b = torch.zeros(512)
    lab = torch.from_numpy(rs.randint(0, 512, (32,)))
    f32 = softmax_ce_head(h, w, b, lab, chunk=128)
    bf = softmax_ce_head(h.to(torch.bfloat16), w.to(torch.bfloat16), b, lab,
                         chunk=128)
    assert bf.dtype == torch.float32
    np.testing.assert_allclose(_np(bf), _np(f32), rtol=0.05, atol=0.05)
