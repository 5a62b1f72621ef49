"""Annotation attrs: keys a node carries for passes and serialization that
are not operator parameters, and `AttrScope`, which attaches attrs to the
symbols made inside it (the counterpart of `mxnet_tpu/attribute.py`;
reference `python/mxnet/attribute.py`)."""
from __future__ import annotations

import threading
from typing import Any, Dict

__all__ = ["ANNOTATION_KEYS", "USER_KEYS_ATTR", "strip_annotations",
           "AttrScope", "current"]

ANNOTATION_KEYS = frozenset({
    "ctx_group", "lr_mult", "wd_mult", "force_mirroring", "__shape__",
    "__dtype__", "__init__", "__storage_type__", "__profiler_scope__",
    "__user_keys__",
})

# reserved node attr listing user-supplied annotation keys (the op
# `attr=` dict): arbitrary names the fixed set cannot enumerate
USER_KEYS_ATTR = "__user_keys__"


def strip_annotations(attrs):
    """Execution-facing attrs: the annotation keys and any user-declared
    annotation keys never reach an op."""
    user = attrs.get(USER_KEYS_ATTR)
    user_set = set(user.split(",")) if isinstance(user, str) else \
        set(user or ())
    return {k: v for k, v in attrs.items()
            if k not in ANNOTATION_KEYS and k not in user_set}


class _State(threading.local):
    def __init__(self):
        super().__init__()
        self.stack = []


_STATE = _State()


class AttrScope:
    """``with AttrScope(ctx_group='dev1'): ...``: every symbol node made
    inside carries these attrs as strings (merged over nested scopes, the
    inner one winning; a node's own attrs win over the scope's), as the
    JAX package's `AttrScope`."""

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}

    def get(self, attrs: Dict[str, Any]) -> Dict[str, Any]:
        merged = dict(self._attrs)
        if attrs:
            merged.update(attrs)
        return merged

    def __enter__(self):
        merged = dict(current()._attrs) if _STATE.stack else {}
        merged.update(self._attrs)
        _STATE.stack.append(AttrScope(**merged))
        return self

    def __exit__(self, *exc):
        _STATE.stack.pop()


_EMPTY = AttrScope()


def current() -> AttrScope:
    """The innermost open scope (an empty one outside any)."""
    return _STATE.stack[-1] if _STATE.stack else _EMPTY
