"""Error taxonomy (a copy of the JAX package's `errors.py`): loaders and
the serving API raise these exceptions, each carrying the integer code of
the original C++ status it stands for."""

from __future__ import annotations


class KuiperError(Exception):
    """Base class (a non-success status)."""

    code = 1  # kInternalError


class InvalidArgument(KuiperError):
    code = 2


class PathNotValid(KuiperError):
    code = 3


class ModelParseError(KuiperError):
    code = 4


class InternalError(KuiperError):
    code = 5


class KeyHasExits(KuiperError):
    code = 6  # spelling kept from the original status name


def check(cond: bool, msg: str, exc=InvalidArgument):
    """Raise `exc(msg)` unless `cond` holds."""
    if not cond:
        raise exc(msg)
