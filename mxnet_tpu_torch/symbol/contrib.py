"""`mx.sym.contrib` (the counterpart of `mxnet_tpu/symbol/contrib.py`;
reference `python/mxnet/symbol/contrib.py`): the ``_contrib_*`` ops the
port registers under their short names, `rand_zipfian`, and the control
flow composers `foreach`, `while_loop` and `cond`, whose body graphs ride
their node as JSON attrs (`ops/control_flow.py`)."""
from ..ops import registry as _reg
from .register import invoke_sym


def _attach():
    g = globals()
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if short not in g:
                def f(*args, _n=name, **kwargs):
                    return invoke_sym(_n, *args, **kwargs)
                f.__name__ = short
                f.__doc__ = _reg.get_op(name).doc
                g[short] = f


_attach()


def rand_zipfian(true_classes, num_sampled, range_max):
    """Symbolic counterpart of `nd.contrib.rand_zipfian` (reference
    `python/mxnet/symbol/contrib.py:rand_zipfian`): candidate sampling
    from the approximate log-uniform distribution, composed as graph
    nodes.  Same int32/float32 deviation as the ndarray side."""
    import math
    from . import random as _random
    log_range = math.log(range_max + 1)
    draws = _random.uniform(0, log_range, shape=(num_sampled,))
    samples = invoke_sym(
        "cast", invoke_sym("exp", draws) - 1, dtype="int32") % range_max

    def expected_count(classes_f):
        upper = invoke_sym("log", (classes_f + 2.0) / (classes_f + 1.0))
        return upper * (num_sampled / log_range)

    true_f = invoke_sym("cast", true_classes, dtype="float32")
    exp_true = expected_count(true_f)
    exp_sampled = expected_count(
        invoke_sym("cast", samples, dtype="float32"))
    return samples, exp_true, exp_sampled


# ---------------------------------------------------------------------------
# symbolic control flow (reference python/mxnet/symbol/contrib.py
# foreach/while_loop/cond + src/operator/control_flow.cc) — the body
# graphs ride the node as JSON attrs (`ops/control_flow.py`)
# ---------------------------------------------------------------------------
import itertools as _it
import json as _json

from ..base import MXNetError as _MXNetError

_CF_UID = _it.count()


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _single_head(s, what):
    if len(s._heads) != 1:
        raise _MXNetError(f"{what} must be single-output symbols")
    return s._heads[0]


def _group(syms):
    from .symbol import Group
    if not syms:
        raise _MXNetError("control-flow body produced no symbols")
    return Group(syms) if len(syms) > 1 else syms[0]


def _free_vars(body_sym, placeholder_names):
    """Outer variables the body graph closes over — ALL inputs including
    auxiliary-state vars (a BatchNorm body's moving stats must thread
    through the node interface; they flow read-only), as
    (names, head-entries)."""
    from .symbol import _topo
    node_of = {}
    for n in _topo(body_sym._heads):
        if n.is_var:
            node_of[n.name] = n
    names = [a for a in body_sym.list_inputs()
             if a not in placeholder_names]
    return names, [(node_of[n], 0) for n in names]


def foreach(body, data, init_states, name="foreach"):
    """Scan `body(item, states) -> (out, new_states)` over dim 0 of
    `data`, as a SYMBOL (reference `symbol/contrib.py:foreach`).
    Returns (outs, final_states); gradients flow through the whole
    loop."""
    from .symbol import var, _new_op_node
    uid = next(_CF_UID)
    data_list, single_data = _as_list(data), not isinstance(
        data, (list, tuple))
    states, single_state = _as_list(init_states), not isinstance(
        init_states, (list, tuple))
    ph_data = [var(f"_foreach{uid}_data{i}")
               for i in range(len(data_list))]
    ph_states = [var(f"_foreach{uid}_state{i}")
                 for i in range(len(states))]
    out, new_states = body(ph_data[0] if single_data else ph_data,
                           ph_states[0] if single_state else ph_states)
    single_out = not isinstance(out, (list, tuple))
    outs, new_states = _as_list(out), _as_list(new_states)
    if len(new_states) != len(states):
        raise _MXNetError(
            f"foreach body returned {len(new_states)} states, expected "
            f"{len(states)}")
    body_sym = _group(outs + new_states)
    ph_names = [s.name for s in ph_data] + [s.name for s in ph_states]
    free_names, free_heads = _free_vars(body_sym, set(ph_names))
    attrs = {
        "__subgraph__": body_sym.tojson(),
        "__data_names__": _json.dumps([s.name for s in ph_data]),
        "__state_names__": _json.dumps([s.name for s in ph_states]),
        "__free_names__": _json.dumps(free_names),
        "__num_out_data__": str(len(outs)),
        "__num_states__": str(len(states)),
    }
    heads = ([_single_head(s, "foreach data") for s in data_list]
             + [_single_head(s, "foreach states") for s in states]
             + free_heads)
    node = _new_op_node("_foreach", heads, attrs, name)
    n_out = len(outs)
    out_syms = [node[i] for i in range(n_out)]
    state_syms = [node[n_out + i] for i in range(len(states))]
    out_val = out_syms[0] if single_out else out_syms
    return out_val, (state_syms[0] if single_state else state_syms)


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """Symbolic while loop (reference `symbol/contrib.py:while_loop`):
    runs `func` while `cond` holds, at most ``max_iterations`` steps;
    per-step outputs are stacked and zero-padded to ``max_iterations``.
    It runs as a masked fixed-trip scan, so it is differentiable (the
    body is evaluated every step; updates are where-gated)."""
    from .symbol import var, _new_op_node
    if max_iterations is None:
        raise _MXNetError("while_loop requires max_iterations")
    uid = next(_CF_UID)
    lvars, single = _as_list(loop_vars), not isinstance(
        loop_vars, (list, tuple))
    ph = [var(f"_while{uid}_var{i}") for i in range(len(lvars))]
    # reference contract (`symbol/contrib.py:388,397`): loop_vars are
    # UNPACKED into cond/func — `cond(*loop_vars)`, `func(*loop_vars)`
    cond_sym = cond(*ph)
    out, new_vars = func(*ph)
    single_out = not isinstance(out, (list, tuple))
    outs, new_vars = _as_list(out), _as_list(new_vars)
    if len(new_vars) != len(lvars):
        raise _MXNetError(
            f"while_loop func returned {len(new_vars)} loop vars, "
            f"expected {len(lvars)}")
    body_sym = _group(outs + new_vars)
    ph_names = {s.name for s in ph}
    cond_free, cond_heads = _free_vars(cond_sym, ph_names)
    body_free, body_heads = _free_vars(body_sym, ph_names)
    attrs = {
        "__cond__": cond_sym.tojson(),
        "__body__": body_sym.tojson(),
        "__var_names__": _json.dumps([s.name for s in ph]),
        "__cond_free__": _json.dumps(cond_free),
        "__body_free__": _json.dumps(body_free),
        "__num_out_data__": str(len(outs)),
        "__num_states__": str(len(lvars)),
        "__max_iterations__": str(int(max_iterations)),
    }
    heads = ([_single_head(s, "while_loop loop_vars") for s in lvars]
             + cond_heads + body_heads)
    node = _new_op_node("_while_loop", heads, attrs, name)
    n_out = len(outs)
    out_syms = [node[i] for i in range(n_out)]
    var_syms = [node[n_out + i] for i in range(len(lvars))]
    # mirror the eager contract: single out if func returned a single
    # symbol, a python LIST otherwise (nd.contrib.while_loop does the
    # same; callers len()/unpack it)
    out_val = out_syms[0] if single_out else out_syms
    return out_val, (var_syms[0] if single else var_syms)


def cond(pred, then_func, else_func, name="cond"):
    """Symbolic if/else (reference `symbol/contrib.py:cond`): both
    branches are composed; outputs must agree in count/shape/dtype.  One
    branch runs."""
    from .symbol import _new_op_node
    then_outs = _as_list(then_func())
    else_outs = _as_list(else_func())
    if len(then_outs) != len(else_outs):
        raise _MXNetError(
            f"cond branches returned {len(then_outs)} vs "
            f"{len(else_outs)} outputs")
    then_sym = _group(then_outs)
    else_sym = _group(else_outs)
    then_free, then_heads = _free_vars(then_sym, set())
    else_free, else_heads = _free_vars(else_sym, set())
    attrs = {
        "__then__": then_sym.tojson(),
        "__else__": else_sym.tojson(),
        "__then_free__": _json.dumps(then_free),
        "__else_free__": _json.dumps(else_free),
        "__num_outputs__": str(len(then_outs)),
    }
    heads = ([_single_head(pred, "cond pred")]
             + then_heads + else_heads)
    node = _new_op_node("_cond", heads, attrs, name)
    outs = [node[i] for i in range(len(then_outs))]
    return outs[0] if len(outs) == 1 else _group(outs)
