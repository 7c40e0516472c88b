"""How the port's model zoo takes ``ctx=``, ``dtype=`` and
``generator=`` at construction."""
from __future__ import annotations

from ... import initializer
from ...context import Context, resolve_device


def materialize(block, ctx, dtype, generator, init) -> None:
    """Give every parameter of ``block`` the dtype ``dtype`` (where not
    None; BatchNorm keeps float32), then, when ``ctx`` or ``generator`` is
    given, initialize it on ``ctx`` (default: the card) with ``init``,
    drawing from ``generator`` in parameter order. With neither, the
    block stays uninitialized for the caller's ``initialize``, as the
    reference's model zoo leaves it."""
    if dtype is not None:
        block.cast(dtype)
    if ctx is None and generator is None:
        return
    ctx = Context.from_device(resolve_device(ctx))
    with initializer.generator_scope(generator):
        block.initialize(init, ctx=ctx)
