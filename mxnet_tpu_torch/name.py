"""Symbol names (the counterpart of `mxnet_tpu/name.py`; reference
`python/mxnet/name.py`): `NameManager` names a symbol after its op with a
per-op counter (``fullyconnected0``), `Prefix` puts a string before every
name made inside it.  The counter lives in `symbol.symbol._NAMES`."""
from __future__ import annotations

from .symbol.symbol import _NAMES, name_prefix_scope

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    """``with NameManager(): ...``: the default manager is always active,
    so entering one changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def get(self, name, hint):
        """``name``, or a new one made from ``hint``."""
        if name is not None:
            return name
        return _NAMES.get(hint)


class Prefix(name_prefix_scope, NameManager):
    """``with Prefix("stage1_"): ...`` puts the prefix before every name
    made inside it."""

    def get(self, name, hint):
        """The prefix goes before an explicit name too, and once before a
        made one (the open scope may have added it already)."""
        if name is not None:
            return self.prefix + name
        auto = _NAMES.get(hint)
        if not auto.startswith(self.prefix):
            auto = self.prefix + auto
        return auto


_current_manager = NameManager()


def current():
    """The active manager: ``current().get(name, hint)``."""
    return _current_manager
