"""``mx.lr_scheduler`` of the port against the JAX package's: every
scheduler, with each warmup mode, read at ``num_update`` 0 ... N in
order (the schedulers keep state between calls), equal as Python floats.
Both are pure Python, so the comparison is exact."""
import pytest

import mxnet_tpu.lr_scheduler as jls

import mxnet_tpu_torch as mx

N = 60

CASES = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.3)),
    ("FactorScheduler", dict(step=5, factor=0.9, base_lr=0.1,
                             warmup_steps=8, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[5, 13, 40], factor=0.3,
                                  base_lr=0.7)),
    ("MultiFactorScheduler", dict(step=[20, 30], factor=0.5, base_lr=0.2,
                                  warmup_steps=10, warmup_begin_lr=0.0)),
    ("PolyScheduler", dict(max_update=45, base_lr=0.25, pwr=2,
                           final_lr=1e-4)),
    ("PolyScheduler", dict(max_update=50, base_lr=0.1, pwr=1.5,
                           warmup_steps=6, warmup_begin_lr=0.02)),
    ("CosineScheduler", dict(max_update=50, base_lr=0.4, final_lr=0.01)),
    ("CosineScheduler", dict(max_update=55, base_lr=0.1, final_lr=0.0,
                             warmup_steps=10, warmup_begin_lr=0.001)),
]


@pytest.mark.parametrize("mode", ["linear", "constant"])
@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_scheduler_matches_reference(name, kw, mode):
    kw = dict(kw, warmup_mode=mode)
    ours = getattr(mx.lr_scheduler, name)(**kw)
    ref = getattr(jls, name)(**kw)
    got = [ours(n) for n in range(N + 1)]
    want = [ref(n) for n in range(N + 1)]
    assert got == want
    assert len(set(got)) > 1


def test_scheduler_refusals_match_reference():
    with pytest.raises(ValueError, match="greater or equal than 1"):
        mx.lr_scheduler.FactorScheduler(step=0)
    sched = mx.lr_scheduler.CosineScheduler(max_update=10, warmup_steps=3,
                                            warmup_mode="cubic")
    with pytest.raises(ValueError, match="cubic"):
        sched(1)
    with pytest.raises(NotImplementedError):
        mx.lr_scheduler.LRScheduler()(0)


def test_optimizer_reads_the_scheduler():
    """``Optimizer.learning_rate`` is the scheduler at ``num_update``; the
    scheduler's ``base_lr`` wins over ``learning_rate``; setting the rate
    by hand under a scheduler raises, as in the reference."""
    sched = mx.lr_scheduler.PolyScheduler(max_update=10, base_lr=0.5)
    opt = mx.optimizer.SGD(learning_rate=9.0, lr_scheduler=sched)
    assert opt.lr == 0.5
    for n in (0, 3, 10):
        opt.num_update = n
        assert opt.learning_rate == sched(n)
    with pytest.raises(mx.MXNetError, match="LRScheduler"):
        opt.set_learning_rate(0.1)
