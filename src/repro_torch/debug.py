"""Run-time sanitizer of the exact-error pipeline, as torch-side checks.

The codec (``repro_torch.dist.compress``, ``repro_torch.core.aggregate``)
carries inline ``debug.check(pred, msg)`` calls for the numeric faults a
static scan cannot see: a non-finite decode, a b-bit field overflow in
the packed wire format, and too much A-clamp mass in the DECOMPOSE draw.
Each call site builds its predicate only under ``if debug.active():``,
and ``check`` reads the predicate (one host sync) only while a
``checked`` entry point runs, so the default path launches no check
kernel and waits for nothing.

Enable globally with ``REPRO_DEBUG_CHECKS=1`` (the round protocol's
encode and decode then run under ``checked``), or locally::

    with repro_torch.debug.checks():
        proto.decode(key, n, msgs, mask, d=d)   # raises on violation

A failed check raises ``debug.SanitizeError`` at the check itself.  The
names follow the JAX package's ``repro.debug``, where the checks compile
into the traced function under checkify; here they run eagerly.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import os
from typing import Callable, Optional

__all__ = [
    "A_CLAMP_MASS_BOUND",
    "ENV_VAR",
    "SanitizeError",
    "active",
    "check",
    "checked",
    "checks",
    "sanitize_enabled",
]

ENV_VAR = "REPRO_DEBUG_CHECKS"

# global_randomness clamps A at a_min; the exact-error argument tolerates
# that only while P[A < a_min] stays negligible.  The decompose law puts
# ~1e-3 mass there for sane geometries: 5% means the geometry is far too
# narrow for the configured clip / sigma.
A_CLAMP_MASS_BOUND = 0.05


class SanitizeError(RuntimeError):
    """A sanitizer check failed."""


# True only while a `checked` entry point runs
_CHECKING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_debug_checking", default=False)

# process-wide override (tests, `with checks():`); None defers to the env
_FORCED: Optional[bool] = None


def sanitize_enabled() -> bool:
    """Should codec entry points run with checks? (env / override)"""
    if _FORCED is not None:
        return _FORCED
    return os.environ.get(ENV_VAR, "").strip().lower() not in (
        "", "0", "false", "off")


@contextlib.contextmanager
def checks(enabled: bool = True):
    """Force the sanitizer on (or off) for the dynamic extent."""
    global _FORCED
    prev = _FORCED
    _FORCED = bool(enabled)
    try:
        yield
    finally:
        _FORCED = prev


def active() -> bool:
    """True while a ``checked`` entry point runs: guard the building of
    every check's predicate with this."""
    return _CHECKING.get()


def check(pred, msg: str, **fmt) -> None:
    """Raise ``SanitizeError(msg.format(**fmt))`` if ``pred`` (a bool or
    a one-element tensor) is false; a no-op outside ``checked``, where
    ``pred`` is not read."""
    if _CHECKING.get() and not bool(pred):
        raise SanitizeError(msg.format(**{k: _plain(v)
                                          for k, v in fmt.items()}))


def _plain(v):
    return v.item() if hasattr(v, "item") else v


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so every ``debug.check`` it reaches is enforced; the
    wrapper raises SanitizeError at the first violated check and returns
    ``fn``'s output otherwise."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        token = _CHECKING.set(True)
        try:
            return fn(*args, **kwargs)
        finally:
            _CHECKING.reset(token)

    return wrapper
