"""Generated `sym.*` surface: one composer per registered op (the
counterpart of `mxnet_tpu/symbol/register.py`), so the same builder code
produces the same graph, and the same JSON, in both packages."""
from __future__ import annotations

from typing import Any, Dict

from ..attribute import USER_KEYS_ATTR
from ..base import MXNetError, _Null
from ..ops import registry as _reg
from ..ops.registry import Attrs
from .symbol import Symbol, _NAMES, _new_op_node, var

__all__ = ["invoke_sym", "make_sym_functions"]


# which named inputs an op consumes given its attrs; composition creates a
# `<node>_<input>` variable for each one not passed (reference ListArguments)
_SYM_INPUTS = {
    "FullyConnected": lambda a: ["data", "weight"] + (
        [] if a.get_bool("no_bias", False) else ["bias"]),
    "Convolution": lambda a: ["data", "weight"] + (
        [] if a.get_bool("no_bias", False) else ["bias"]),
    "Deconvolution": lambda a: ["data", "weight"] + (
        [] if a.get_bool("no_bias", True) else ["bias"]),
    "InstanceNorm": lambda a: ["data", "gamma", "beta"],
    "BatchNorm": lambda a: ["data", "gamma", "beta", "moving_mean",
                            "moving_var"],
    "LayerNorm": lambda a: ["data", "gamma", "beta"],
    "Embedding": lambda a: ["data", "weight"],
    "LeakyReLU": lambda a: (["data", "gamma"]
                            if a.get_str("act_type", "leaky") == "prelu"
                            else ["data"]),
    "RNN": lambda a: ["data", "parameters", "state"] + (
        ["state_cell"] if a.get_str("mode", "lstm") == "lstm" else []),
    # output heads create their `<name>_label` variable when not given
    "SoftmaxOutput": lambda a: ["data", "label"],
    "Softmax": lambda a: ["data", "label"],
    "LinearRegressionOutput": lambda a: ["data", "label"],
    "MAERegressionOutput": lambda a: ["data", "label"],
    "LogisticRegressionOutput": lambda a: ["data", "label"],
    "SVMOutput": lambda a: ["data", "label"],
}


def _user_attrs(user_attr) -> Dict[str, Any]:
    """An op's ``attr={...}``, checked as the reference checks it: each
    key is marked ``__key__`` (a bare key could override an op parameter)
    and holds no comma or whitespace (the keys are joined by commas into
    ``__user_keys__``, which `strip_annotations` splits before the op
    runs)."""
    for k in user_attr:
        if not (k.startswith("__") and k.endswith("__") and len(k) > 4):
            raise MXNetError(f"Attribute name {k!r} is not supported. Op "
                             "attributes must be marked like __key__")
        if "," in k or any(c.isspace() for c in k):
            raise MXNetError(f"Attribute name {k!r} is not supported: "
                             "commas and whitespace are not allowed in "
                             "attribute keys")
    return {**user_attr, USER_KEYS_ATTR: ",".join(sorted(user_attr))}


def invoke_sym(op_name: str, *args, name=None, **kwargs) -> Symbol:
    op = _reg.get_op(op_name)
    user_attr = kwargs.pop("attr", None)
    inputs, pos_attrs = _reg.split_positional_attrs(
        op, [a for a in args if a is not None], kwargs, Symbol)
    kwargs.update(pos_attrs)
    named = {k: kwargs.pop(k) for k in list(kwargs)
             if isinstance(kwargs[k], Symbol)}
    # an explicit None is kept: Attrs accessors read it as "not given"
    attrs: Dict[str, Any] = {k: v for k, v in kwargs.items()
                             if v is not _Null}
    if name is None:
        name = _NAMES.get(op_name.lstrip("_"))
    if user_attr:
        attrs.update(_user_attrs(user_attr))

    if op_name in _SYM_INPUTS:
        want = _SYM_INPUTS[op_name](Attrs(attrs))
        pos = {want[i]: s for i, s in enumerate(inputs) if i < len(want)}
        pos.update(named)
        # a parameter made here carries the op's user attrs
        extra = {"attr": dict(user_attr)} if user_attr else {}
        inputs = [pos[n] if n in pos else var(f"{name}_{n}", **extra)
                  for n in want]
    elif named and op.input_names:
        pos = {op.input_names[i]: s for i, s in enumerate(inputs)}
        pos.update(named)
        inputs = [pos[n] for n in op.input_names if n in pos]
    elif named:
        inputs.extend(named.values())

    heads = []
    for s in inputs:
        if not isinstance(s, Symbol):
            raise TypeError(
                f"sym.{op_name}: inputs must be Symbols, got {type(s)}")
        heads.extend(s._heads)
    return _new_op_node(op_name, heads, attrs, name)


def make_sym_functions(module_dict: Dict[str, Any]) -> None:
    for op_name in _reg.list_ops():
        if op_name in module_dict:
            continue

        def f(*args, _n=op_name, name=None, **kwargs):
            return invoke_sym(_n, *args, name=name, **kwargs)
        f.__name__ = op_name
        f.__doc__ = _reg.get_op(op_name).doc
        module_dict[op_name] = f
