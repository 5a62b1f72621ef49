"""`mx.sym`: graph construction plus one composer per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .register import invoke_sym, make_sym_functions
from .symbol import Group, Symbol, load_json, var

make_sym_functions(globals())

__all__ = ["Symbol", "var", "Group", "load_json", "invoke_sym"]
