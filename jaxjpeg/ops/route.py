"""The one place that maps the platform to an implementation of a device op.

Every op with a hand-written kernel also has a plain ``jax.numpy`` version
of the same arithmetic:

* ``"kernel"``: the compiled kernel (Pallas through Triton) -- on ``gpu``.
* ``"plain"``: the plain version, compiled by XLA -- on ``cpu``.
* ``"interpret"``: the kernel body run by the Pallas interpreter -- only
  when a caller passes ``interpret=True`` (tests of the kernel on a host
  without a GPU).

Any other platform is an error: there is no silent fallback.
``forced`` pins a route while a benchmark traces the version it times.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax

KERNEL = "kernel"
PLAIN = "plain"
INTERPRET = "interpret"

_BY_PLATFORM = {"gpu": KERNEL, "cpu": PLAIN}
_forced: dict = {}  # op name (or None: every op) -> route


def route(
    interpret: Optional[bool] = None,
    platform: Optional[str] = None,
    op: Optional[str] = None,
) -> str:
    """The implementation of ``op`` to run: KERNEL, PLAIN or INTERPRET.

    ``platform`` defaults to JAX's default backend.
    """
    if interpret:
        return INTERPRET
    pinned = _forced.get(op, _forced.get(None))
    if pinned is not None:
        return pinned
    platform = platform or jax.default_backend()
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"no device route for platform {platform!r}: the kernels are "
            "compiled for 'gpu' and the plain versions run on 'cpu'"
        ) from None


@contextlib.contextmanager
def forced(name: str, op: Optional[str] = None) -> Iterator[None]:
    """Trace ``op`` (default: every op) with the route ``name`` (KERNEL or
    PLAIN) on any platform.

    Only for code traced inside the block: functions jitted elsewhere keep
    whatever route their first trace took.
    """
    if name not in (KERNEL, PLAIN):
        raise ValueError(f"unknown route {name!r}")
    prev = dict(_forced)
    _forced[op] = name
    try:
        yield
    finally:
        _forced.clear()
        _forced.update(prev)
