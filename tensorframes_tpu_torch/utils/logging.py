"""Logging setup (≙ the reference's ``Logging`` trait, Logging.scala:5-9,
and its log4j bootstrap, PythonInterface.scala:29-44 — here just stdlib
logging with a package-level logger and an opt-in debug env var).

The ``TFTPU_LOG`` environment variable is re-read on every
:func:`get_logger` call, so a test (or an operator attaching to a live
process via a debugger) can flip verbosity without re-importing the
package. :func:`set_level` pins the level explicitly and stops the env
re-reads — an in-code decision outranks ambient environment."""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

_ROOT = "tensorframes_tpu_torch"

#: Explicitly-pinned level (via set_level); None → follow TFTPU_LOG.
_pinned_level: Optional[int] = None

#: Last TFTPU_LOG value applied (sentinel → never applied). The env is
#: re-applied only when its value CHANGES, so a user who configured the
#: root via plain ``logging.getLogger("tensorframes_tpu_torch").setLevel(...)``
#: is not silently clobbered by the next get_logger call.
_UNSET = object()
_last_env_level = _UNSET


def _coerce_level(level: Union[int, str]) -> int:
    if isinstance(level, int):
        return level
    resolved = getattr(logging, str(level).upper(), None)
    if not isinstance(resolved, int):
        raise ValueError(f"unknown log level {level!r}")
    return resolved


def _ensure_handler() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(handler)
    return root


def get_logger(name: str = _ROOT) -> logging.Logger:
    """Package logger factory. Unless :func:`set_level` has pinned a
    level, ``TFTPU_LOG`` is re-read at every call and applied whenever
    its value has changed — never frozen at whatever the env said the
    first time, and never clobbering a level set directly on the root
    logger in between env changes."""
    global _last_env_level
    root = _ensure_handler()
    if _pinned_level is None:
        level = os.environ.get("TFTPU_LOG", "WARNING").upper()
        if level != _last_env_level:
            _last_env_level = level
            root.setLevel(getattr(logging, level, logging.WARNING))
    return logging.getLogger(name)


def set_level(level: Union[int, str]) -> None:
    """Pin the package log level (``"DEBUG"``/``logging.DEBUG``/...).
    Overrides — and stops tracking — the ``TFTPU_LOG`` env var; call
    :func:`clear_level` to hand control back to the environment."""
    global _pinned_level
    _pinned_level = _coerce_level(level)
    _ensure_handler().setLevel(_pinned_level)


def clear_level() -> None:
    """Un-pin: the next :func:`get_logger` follows ``TFTPU_LOG`` again
    (and re-applies it, whatever its current value)."""
    global _pinned_level, _last_env_level
    _pinned_level = None
    _last_env_level = _UNSET
