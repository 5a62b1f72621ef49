"""Annotation attrs: keys a node carries for passes and serialization that
are not operator parameters (the counterpart of the strip rule in
`mxnet_tpu/attribute.py`)."""
from __future__ import annotations

__all__ = ["ANNOTATION_KEYS", "USER_KEYS_ATTR", "strip_annotations"]

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
