"""The port's `fault_injection` against the JAX package's: the same
`FaultPlan` / `FilePlan` spec driven by the same scripted sequence of
events gives the same ``summary()``, the same hook calls and the same
raised faults in both packages -- every event family, the seeded
Bernoulli drops, the seeded corruption offsets -- and the environment
plans (``MXTPU_PS_FAULT_PLAN``, ``MXTPU_CKPT_FAULT_PLAN``) parse and
cache alike."""
import os
import socket

import pytest

from mxnet_tpu import fault_injection as jfi
from mxnet_tpu_torch import fault_injection as tfi

PKGS = {"port": tfi, "reference": jfi}

SPECS = [
    "seed=7,duplicate_every=3,drop_recv_every=5",
    "seed=3,drop_prob=0.3,delay_at=2+4,delay_s=0.0,timeout_at=6+7",
    "drop_send_after=2,duplicate_at=1+4,kill_server_at=3,join_at=5+8,"
    "drain_at=6,kill_rejoin_at=7",
    "kill_replica_at=2+5,hang_replica_at=3,corrupt_blob_on_deploy=1+3",
    "preempt_at=2,kill_worker_at=4,kill_device_at=1,hang_device_at=3",
    "traffic_spike_at=2+4,kill_replica_during_scale=1+3",
]


def _drive(fi, spec, n=8):
    """Every event family ``n`` times, recording each outcome and hook
    call; returns the record and the plan's summary."""
    calls = []
    plan = fi.FaultPlan.from_spec(spec)
    for name in ("on_kill", "on_join", "on_drain", "on_kill_rejoin"):
        setattr(plan, name, lambda name=name: calls.append(name))
    for name in ("on_kill_replica", "on_hang_replica", "on_preempt",
                 "on_kill_worker", "on_kill_device", "on_hang_device",
                 "on_traffic_spike", "on_kill_replica_during_scale"):
        setattr(plan, name, lambda i, name=name: calls.append((name, i)))
    seen = []
    for _ in range(n):
        for event in ("client_send_event", "client_recv_event"):
            try:
                seen.append((event, getattr(plan, event)()))
            except (ConnectionError, socket.timeout) as e:
                seen.append((event, type(e).__name__, str(e)))
        for event in ("router_dispatch_event", "deploy_event",
                      "driver_step_event", "mesh_step_event",
                      "autoscale_poll_event", "scale_event"):
            seen.append((event, getattr(plan, event)()))
    return seen, calls, plan.summary()


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_same_script_same_summary(spec):
    mine, ref = _drive(tfi, spec), _drive(jfi, spec)
    assert mine == ref
    assert sum(mine[2].values()) > 0


def test_injected_fault_types_mirror_the_reference():
    assert issubclass(tfi.InjectedFault, ConnectionError)
    assert issubclass(tfi.InjectedCrash, RuntimeError)
    from mxnet_tpu_torch.base import MXNetError
    assert not issubclass(tfi.InjectedCrash, MXNetError)


def _drive_file(fi, spec, directory, writes=4):
    """``writes`` hook sequences of a FilePlan over files of 64 bytes,
    as `serialization.atomic_write` calls them."""
    plan = fi.FilePlan.from_spec(spec)
    out = []
    for k in range(writes):
        f = os.path.join(directory, f"f{k}")
        with open(f, "wb") as h:
            h.write(bytes(range(64)))
        n = plan.write_begin(f)
        step = []
        for hook, args in (("on_fsync", (n,)), ("on_pre_rename", (n,)),
                           ("on_committed", (n, f))):
            try:
                getattr(plan, hook)(*args)
                step.append(hook)
            except (OSError, fi.InjectedCrash) as e:
                step.append((hook, type(e).__name__, str(e)))
                break
        out.append((step, open(f, "rb").read()))
    return out, plan.summary()


@pytest.mark.parametrize("spec", [
    "kill_before_rename=2,fail_fsync=3",
    "seed=11,truncate_on_write=1+3,flip_on_write=2+4",
    "truncate_on_write=1,truncate_at=10,flip_on_write=1,flip_at=5"])
def test_file_plan_same_script_same_summary(spec, tmp_path):
    a, b = tmp_path / "port", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    assert _drive_file(tfi, spec, str(a)) == _drive_file(jfi, spec, str(b))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_env_plans_parse_once_and_install_wins(pkg, monkeypatch):
    fi = PKGS[pkg]
    fi._ENV_PLANS.clear()
    fi._FILE_ENV_PLANS.clear()
    assert fi.active() is None and fi.file_active() is None
    monkeypatch.setenv("MXTPU_PS_FAULT_PLAN", "seed=7,duplicate_every=3")
    monkeypatch.setenv("MXTPU_CKPT_FAULT_PLAN", "kill_before_rename=3")
    plan, fplan = fi.active(), fi.file_active()
    assert plan is fi.active() and fplan is fi.file_active()  # cached
    assert plan.duplicate_every == 3 and plan.seed == 7
    assert fplan.kill_before_rename == frozenset({3})
    mine = fi.install(fi.FaultPlan(seed=1))
    fmine = fi.install_file(fi.FilePlan(seed=1))
    assert fi.active() is mine and fi.file_active() is fmine
    fi.clear()
    fi.clear_file()
    assert fi.active() is plan and fi.file_active() is fplan
    fi._ENV_PLANS.clear()
    fi._FILE_ENV_PLANS.clear()


def test_spec_parse_matches_reference():
    spec = "a=1,b=2.5,c=x,d=1+2+3, e = 4 ,"
    assert tfi._spec_kwargs(spec) == jfi._spec_kwargs(spec)
    assert tfi._as_indices(None) == jfi._as_indices(None) == frozenset()
    assert tfi._as_indices(3) == frozenset({3})
    assert tfi._as_indices((1, 2)) == jfi._as_indices([2, 1])


SLICE_KNOBS = (
    ["MXTPU_PS_FAULT_PLAN", "MXTPU_CKPT_FAULT_PLAN"]
    + [f"MXTPU_SERVE_{k}" for k in (
        "FLEET", "DRAIN_TIMEOUT", "HEALTH_INTERVAL", "HEALTH_TIMEOUT",
        "BREAKER_FAILURES", "BREAKER_COOLDOWN_S", "BREAKER_P99_MS",
        "ROUTER_TIMEOUT", "DEPLOY_TIMEOUT", "AUTOSCALE",
        "SCALE_UP_QUEUE_ROWS", "SCALE_UP_P99_MS", "SCALE_DOWN_QUEUE_ROWS",
        "SCALE_IDLE_S", "SCALE_COOLDOWN_S", "MIN_REPLICAS", "MAX_REPLICAS",
        "SCALE_INTERVAL_S", "WARMUP_TIMEOUT_S", "PRIORITY",
        "BROWNOUT_DELAY_FACTOR", "BROWNOUT_RUNG_CAP")]
    + [f"MXTPU_GEN_{k}" for k in ("CONTINUOUS", "SLOTS", "CHUNK_STEPS",
                                  "QUEUE_LIMIT", "MAX_PROMPT", "MAX_TOKENS",
                                  "STALL_MS")])


@pytest.mark.parametrize("name", SLICE_KNOBS)
def test_slice_knobs_as_the_reference(name, monkeypatch):
    """The knobs this slice reads are registered under the JAX package's
    names, defaults and types: unset and set to a sample, both packages'
    `get_env` read the same value."""
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config as tconfig
    assert name in tconfig._R
    assert tconfig.get_env(name) == jconfig.get_env(name)
    for raw in ("0", "3", "2.5", "x"):
        monkeypatch.setenv(name, raw)
        assert tconfig.get_env(name) == jconfig.get_env(name), raw
    assert set(tconfig._R) <= set(jconfig._R)
