"""The port's static analysis (`mxnet_tpu_torch.analysis`) against the JAX
package's: every lint rule fires on the same crafted snippets as
`mxnet_tpu.analysis.lint_rules` (``host-sync-in-capture`` where the JAX
package has ``host-sync-in-jit``), the port's tree lints clean against its
own baseline, and the program auditor finds each rule's fault in a plan
the port captures and nothing in clean ones."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mxnet_tpu.analysis import lint_rules as jlint

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config, profiler
from mxnet_tpu_torch.analysis import lint_rules as lint
from mxnet_tpu_torch.analysis import program_audit as audit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPETS = {
    "env_unregistered": ("mxnet_tpu/x.py", '''
from .config import get_env
v = get_env("MXTPU_NOT_A_KNOB")
'''),
    "env_raw_read": ("mxnet_tpu/x.py", '''
import os
v = os.environ.get("MXTPU_SERVE_MAX_BATCH")
w = os.environ["MXNET_PROFILER_MODE"]
u = os.getenv("DMLC_ROLE")
'''),
    "env_dynamic": ("mxnet_tpu/x.py", '''
import os
k = "A"
v = os.environ.get(k)
'''),
    "env_registered_ok": ("mxnet_tpu/x.py", '''
from .config import get_env
v = get_env("MXTPU_SERVE_MAX_BATCH")
os.environ["MXTPU_SERVE_MAX_BATCH"] = "3"
'''),
    "env_in_config_ok": ("mxnet_tpu/config.py", '''
import os
raw = os.environ.get("MXTPU_ANYTHING")
'''),
    "pickle_in_serving": ("mxnet_tpu/serving.py", '''
import pickle
from cPickle import loads
import dill.core
'''),
    "pickle_elsewhere_ok": ("mxnet_tpu/model.py", '''
import pickle
'''),
    "signal_clobber": ("mxnet_tpu/x.py", '''
import signal
def install():
    signal.signal(signal.SIGTERM, lambda s, f: None)
'''),
    "signal_chained_ok": ("mxnet_tpu/x.py", '''
import signal
def install():
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, prev)
def other():
    old = signal.signal(signal.SIGINT, signal.SIG_IGN)
'''),
    "ckpt_raw_write": ("mxnet_tpu/checkpoint.py", '''
import os, shutil
def save(path, data):
    with open(path, "wb") as f:
        f.write(data)
    os.replace(path, path + ".x")
    shutil.move(path, path + ".y")
def atomic_write(path, data):
    with open(path, "wb") as f:
        f.write(data)
def load(path):
    return open(path, "rb").read()
'''),
    "suppressed": ("mxnet_tpu/x.py", '''
import os
# mxtpu-lint: disable=raw-env-read -- the launcher's protocol,
# read before config exists
v = os.environ.get("DMLC_ROLE")
w = os.environ.get("DMLC_RANK")  # mxtpu-lint: disable=raw-env-read
'''),
    "syntax_error": ("mxnet_tpu/x.py", "def broken(:\n"),
}


def _keys(findings):
    return sorted((f.rule, f.line, f.token) for f in findings)


@pytest.fixture(scope="module")
def cfgs():
    with open(os.path.join(ROOT, "mxnet_tpu_torch", "config.py")) as f:
        port = lint.collect_registered_env(f.read())
    with open(os.path.join(ROOT, "mxnet_tpu", "config.py")) as f:
        ref = jlint.collect_registered_env(f.read())
    return port, ref


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_rules_fire_like_the_reference(cfgs, name):
    path, src = SNIPPETS[name]
    port_cfg, ref_cfg = cfgs
    got = lint.lint_source(src, path.replace("mxnet_tpu/", "mxnet_tpu_torch/"),
                           port_cfg)
    ref = jlint.lint_source(src, path, ref_cfg)
    assert _keys(got) == _keys(ref)
    assert [f.message.split(" ")[0] for f in got] or not ref


CAPTURE_SNIPPETS = {
    "bare": ('''
import jax
def step(x):
    y = x.sum().item()
    return float(x) + int(y)
f = jax.jit(step)
''', '''
from .graph_compile import CapturedGraph
def run(dev):
    def step():
        y = x.sum().item()
        return float(x) + int(y)
    g = CapturedGraph(step, dev)
'''),
    "decorated_vs_warm_up": ('''
import jax
@jax.jit
def step(x):
    return x.tolist()
''', '''
from . import graph_compile as gc
def step():
    return x.tolist()
gc.warm_up(step, dev)
'''),
    "method_named_alike_ok": ('''
import jax
class S:
    def step(self):
        return self.x.item()
def make():
    def step(x):
        return x
    return jax.jit(step)
''', '''
class S:
    def step(self):
        return self.x.item()
def make(dev):
    def step():
        return x
    return CapturedGraph(step, dev)
'''),
    "constant_casts_ok": ('''
import jax
@jax.jit
def step(x):
    return x * float(2) + int(3)
''', '''
def step():
    return x * float(2) + int(3)
CapturedGraph(step, dev)
'''),
}


@pytest.mark.parametrize("name", sorted(CAPTURE_SNIPPETS))
def test_host_sync_in_capture_mirrors_host_sync_in_jit(name):
    ref_src, port_src = CAPTURE_SNIPPETS[name]
    ref = jlint.lint_source(ref_src, "mxnet_tpu/x.py",
                            rules=["host-sync-in-jit"])
    got = lint.lint_source(port_src, "mxnet_tpu_torch/x.py",
                           rules=["host-sync-in-capture"])
    assert sorted(f.token.split(":")[1] for f in got) == \
        sorted(f.token.split(":")[1] for f in ref)


def test_host_sync_rule_knows_torch_syncs():
    src = '''
import torch
def body():
    torch.cuda.synchronize()
    return t.cpu(), t.numpy()
CapturedGraph(body, dev)
'''
    got = lint.lint_source(src, "mxnet_tpu_torch/x.py",
                           rules=["host-sync-in-capture"])
    assert sorted(f.token for f in got) == [
        "body:.cpu()", "body:.numpy()", "body:torch.cuda.synchronize()"]


def test_rule_set_mirrors_the_reference():
    assert set(lint.RULES) - {"host-sync-in-capture"} == \
        set(jlint.RULES) - {"host-sync-in-jit"}
    assert lint.WIRE_MODULES == jlint.WIRE_MODULES
    assert lint.CKPT_MODULES == jlint.CKPT_MODULES


def test_the_ports_tree_lints_clean_against_its_baseline():
    spec = importlib.util.spec_from_file_location(
        "torch_lint", os.path.join(ROOT, "tools", "torch_lint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    import io
    new, _n, stale = tool.run_lint(out=io.StringIO())
    assert not new and not stale
    files = lint.iter_python_files(ROOT)
    assert "mxnet_tpu_torch/serving.py" in files
    assert "chip_smoke.py" in files
    assert not any(f.startswith("mxnet_tpu/") for f in files)


def test_every_knob_the_slice_reads_is_registered_as_in_the_reference():
    from mxnet_tpu import config as jconfig
    names = ["MXNET_PROFILER_AUTOSTART", "MXNET_PROFILER_MODE",
             "MXTPU_SERVE_BATCH_LADDER", "MXTPU_SERVE_MAX_BATCH",
             "MXTPU_SERVE_MAX_DELAY_MS", "MXTPU_SERVE_QUEUE_LIMIT",
             "MXTPU_SERVE_RETRY_DEADLINE", "MXTPU_SERVE_DRAIN_TIMEOUT",
             "MXTPU_SERVE_PRIORITY", "MXTPU_TELEMETRY_DIR",
             "MXTPU_FLIGHT_RECORDER", "MXTPU_FLIGHT_RECORDER_SIZE",
             "MXTPU_FLIGHT_RECORDER_PATH", "MXTPU_FLIGHT_RECORDER_SIGNALS",
             "MXTPU_FLIGHT_RECORDER_MIN_INTERVAL_S", "MXTPU_SLOW_STEP_WINDOW",
             "MXTPU_SLOW_STEP_FACTOR", "MXTPU_WORKER_ID", "MXTPU_PS_ADDR"]
    ref = jconfig.registry()
    for n in names:
        assert n in config._R and n in ref, n
        assert config._R[n].default == ref[n].default, n
        assert config.get_env(n) == jconfig.get_env(n), n
    # the port registers no knob the JAX package lacks
    assert not set(config._R) - set(ref)


# ---------------------------------------------------------------------------
# the program auditor
# ---------------------------------------------------------------------------

def _module(optimizer="sgd", params=None):
    data = mt.sym.Variable("data")
    label = mt.sym.Variable("softmax_label")
    h = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mt.sym.Activation(h, act_type="relu")
    h = mt.sym.FullyConnected(h, num_hidden=4, name="fc2")
    out = mt.sym.SoftmaxOutput(h, label, name="softmax")
    mod = mt.mod.Module(out, data_names=["data"],
                        label_names=["softmax_label"], context=mt.cpu())
    mod.bind(data_shapes=[("data", (6, 5))],
             label_shapes=[("softmax_label", (6,))], for_training=True)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer=optimizer, optimizer_params=params or {
        "learning_rate": 0.05, "momentum": 0.9})
    rng = np.random.RandomState(7)
    batch = mt.io.DataBatch(
        data=[mt.nd.array(rng.randn(6, 5).astype(np.float32),
                          ctx=mt.cpu())],
        label=[mt.nd.array((rng.rand(6) * 4).astype(np.float32),
                           ctx=mt.cpu())])
    return mod, batch


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.003, "wd": 1e-4}),
])
def test_unified_step_audits_clean(optimizer, params):
    profiler.reset_audit_counters()
    mod, batch = _module(optimizer, params)
    assert mod.fused_step(batch, eval_metric=mt.metric.Accuracy())
    assert mod._fused_train_step.audit() == []
    c = profiler.audit_counters()
    assert c["programs_audited"] == 1 and c["clean_programs"] == 1
    assert c["donated_leaves_checked"] == c["donation_aliases_confirmed"] > 0


def test_audit_needs_a_step_first():
    mod, batch = _module()
    mod.fused_step(batch)
    step = mod._fused_train_step
    step._audit_last = None
    with pytest.raises(RuntimeError):
        step.audit()


def test_donation_miss_when_a_weight_is_rebound():
    mod, batch = _module()
    assert mod.fused_step(batch)
    step = mod._fused_train_step
    last = step._audit_last
    key = next(k for k in last["after"] if k.startswith("weight:"))
    last["after"][key] += 64  # as if the tensor had been replaced
    profiler.reset_audit_counters()
    found = step.audit()
    assert [f.rule for f in found] == [audit.R_DONATION]
    c = profiler.audit_counters()
    assert c["findings_total"] == 1 and c["findings_donation_miss"] == 1


def test_retrace_hazard_when_lr_is_a_static_hyperparameter():
    mod, batch = _module()
    assert mod.fused_step(batch)
    step = mod._fused_train_step
    op, static, poss = step._audit_last["layout"][0]
    static = dict(static, lr=0.05)
    step._audit_last["layout"][0] = (op, static, poss)
    found = step.audit()
    assert [f.rule for f in found] == [audit.R_RETRACE]
    assert found[0].extra == {"label": "lr", "value": 0.05}


def _plan(sym):
    from mxnet_tpu_torch.graph_compile import build_steps
    return build_steps(sym)


def test_retrace_hazard_in_a_plan_attr():
    x = mt.sym.Variable("x")
    plan = _plan(mt.sym._mul_scalar(x, scalar=0.0123))
    found = audit.audit_plan("p", plan, hazard_values={"lr": [0.0123],
                                                       "wd": [0.0]})
    assert [f.rule for f in found] == [audit.R_RETRACE]
    assert audit.audit_plan("p", plan, hazard_values={"lr": [0.5]}) == []


def test_f64_promotion_found_only_without_f64_inputs():
    x = mt.sym.Variable("x")
    sym = mt.sym.Cast(mt.sym.tanh(x), dtype="float64")
    plan = _plan(sym)
    f32 = {"x": torch.zeros(2, 3)}
    found = audit.audit_plan("p", plan, feed=f32)
    assert [f.rule for f in found] == [audit.R_F64]
    assert found[0].primitive.lower() == "cast"
    assert audit.audit_plan("p", plan,
                            feed={"x": torch.zeros(2, 3,
                                                   dtype=torch.float64)}) == []


def _custom_head():
    from mxnet_tpu_torch import operator

    class _Id(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])

    @operator.register("audit_identity")
    class _IdProp(operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return _Id()

    x = mt.sym.Variable("x")
    h = mt.sym.tanh(x)
    h = mt.sym.Custom(h, op_type="audit_identity")
    return mt.sym.exp(h)


def test_host_callback_in_a_captured_plan():
    plan = _plan(_custom_head())
    found = audit.audit_plan("p", plan)
    assert [f.rule for f in found] == [audit.R_HOST_CALLBACK]
    assert found[0].primitive == "Custom"


def test_island_program_declares_its_host_nodes():
    with mt.cpu():
        exe = _custom_head().simple_bind(mt.cpu(), x=(2, 3),
                                         grad_req="null")
        prog = exe.graph_program(False)
    assert prog.fallback_nodes == 1
    assert prog.audit(exe._feed()) == []


def test_host_callback_inside_a_control_flow_body():
    data = mt.sym.Variable("data")
    init = mt.sym.Variable("init")

    def body(item, states):
        h = mt.sym.Custom(item + states[0], op_type="audit_identity")
        return [h], [h]

    _custom_head()  # registers the op
    outs, _ = mt.sym.contrib.foreach(body, data, [init])
    found = audit.audit_plan("p", _plan(outs[0]))
    assert [f.rule for f in found] == [audit.R_HOST_CALLBACK]
    assert "/__subgraph__/" in found[0].location or \
        "/__body__/" in found[0].location


def test_clean_graph_program_and_dump(capsys):
    with mt.cpu():
        x = mt.sym.Variable("x")
        exe = mt.sym.tanh(x).simple_bind(mt.cpu(), x=(2, 3),
                                         grad_req="null")
        exe.compiled_forward(is_train=False)
        assert exe.graph_program(False).audit(exe._feed()) == []
    audit.dump_findings([])
    audit.dump_findings([audit.Finding("p", audit.R_F64, "steps[0]", "d",
                                       primitive="Cast")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "AUDIT-FINDINGS none"
    assert out[1].startswith("AUDIT-FINDINGS {") and '"Cast"' in out[1]
    f = audit.Finding("p", audit.R_F64, "steps[0]", "d", primitive="Cast")
    assert f.key == "f64-promotion:p:Cast"
