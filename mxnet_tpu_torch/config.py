"""Environment knobs this package reads, under the JAX package's names so
that one variable drives both packages.

``MXTPU_PALLAS`` and ``MXTPU_PALLAS_MIN_FLOPS`` keep their names but select
the hand-written Hopper kernels of `ops/hopper_kernels.py` here:
``MXTPU_PALLAS=auto`` means "the bound device is CUDA with compute
capability (9, 0)", ``1`` swaps on any device (a CPU tensor then takes the
kernel's plain PyTorch version), ``0`` never swaps.
"""
from __future__ import annotations

import os
from collections import namedtuple
from typing import Any, Dict, Optional

__all__ = ["EnvVar", "get_env", "set_env", "registry", "summary",
           "ACTIVE", "SUBSUMED", "NOT_APPLICABLE"]

#: a knob's status, as the JAX package classifies its knobs: ``active``
#: changes behavior here; ``subsumed`` and ``n/a`` are accepted and have
#: no effect (every knob this package registers is active)
ACTIVE = "active"
SUBSUMED = "subsumed"
NOT_APPLICABLE = "n/a"

EnvVar = namedtuple("EnvVar", ["name", "type", "default", "status", "doc"])

_R: Dict[str, EnvVar] = {}


def _reg(name, typ, default, doc, status=ACTIVE):
    _R[name] = EnvVar(name, typ, default, status, doc)


_reg("MXTPU_GRAPH_OPT", str, "1",
     "graph-rewrite pipeline kill switch; '0'/'false'/'off' runs the bound "
     "symbol unoptimized (graph_opt.graph_opt_enabled)")
_reg("MXTPU_GRAPH_OPT_SKIP", str, "",
     "comma-separated pass names to disable individually "
     "(graph_opt.skipped_passes)")
_reg("MXTPU_PALLAS", str, "auto",
     "Hopper kernel selection: 'auto' swaps matched subgraphs only when "
     "the bound device is CUDA capability (9, 0), '1' on any device, "
     "'0'/'off' never (graph_opt.pallas_mode)")
_reg("MXTPU_PALLAS_MIN_FLOPS", float, 1e6,
     "kernel-selection floor: an attention site below this analytic flop "
     "count keeps the unfused graph (graph_opt pallas_select)")
_reg("MXTPU_UNIFIED_STEP", str, "1",
     "training pass list: on, the unified list (eliminate, cse, dead_aux); "
     "'0'/'false'/'off', the legacy pair (cse, dead_aux) "
     "(graph_opt.train_passes)")


_reg("MXTPU_GRAPH_OPT_VERIFY", str, "0",
     "'1' value-verifies every optimized training graph bitwise "
     "(outputs, aux updates, gradients) against the unoptimized graph "
     "when it is built (graph_opt.training_symbol)")
_reg("MXTPU_CONV_LAYOUT", str, "",
     "'NHWC' runs convolution and pooling channels-last (torch's "
     "channels_last memory format, which cuDNN takes natively); read once "
     "at import (ops/nn.py), so set it before importing the package")
_reg("MXTPU_GRAPH_OPT_FOLD_MAX_MB", int, 64,
     "constant-folding budget: skip the fold when the baked constants "
     "would exceed this many MB (graph_opt fold_const)")
_reg("MXTPU_GRAPH_COMPILE", str, "1",
     "CUDA-graph capture of inference programs and training steps; "
     "'0'/'false'/'off' runs their steps eagerly "
     "(graph_compile.graph_compile_enabled)")
_reg("MXTPU_GRAPH_COMPILE_DENY", str, "",
     "comma-separated op names added to the non-lowerable deny set — "
     "the escape hatch for an op that mis-lowers in one trace "
     "(graph_compile.deny_ops)")
_reg("MXNET_SUBGRAPH_BACKEND", str, "",
     "applies the named subgraph-partition pass at bind (subgraph.py); "
     "low-level op fusion itself remains XLA's job")
_reg("MXTPU_FUSED_STEP", str, "1",
     "one-step training plane; '0'/'false'/'off' makes Module.fit run "
     "forward_backward + the per-parameter update "
     "(fused_step.fused_enabled)")
_reg("MXTPU_UNIFIED_METRIC", str, "1",
     "fit's metric accumulated inside the training step; "
     "'0'/'false'/'off' keeps the per-step host update_metric "
     "(unified_step.metric_in_trace_enabled)")


def _flag(raw) -> bool:
    """dmlc's bool: "0", "false" and "" are false, anything else true."""
    return str(raw).strip().lower() not in ("0", "false", "")


_reg("MXTPU_ANOMALY_GUARD", _flag, False,
     "device-side finite check of the loss outputs and the global "
     "gradient norm inside the training step: a non-finite step leaves "
     "the parameters, optimizer states and aux states as they were "
     "(unified_step.anomaly_guard_enabled)")


_reg("MXTPU_ANOMALY_LIMIT", int, 3,
     "consecutive anomaly-guard skips that raise GradientAnomalyError "
     "(train_driver.AnomalyGuard)")

# --- the SPMD plane (parallel/) ------------------------------------------
_reg("MXTPU_SPMD", str, "",
     "one-program data parallelism for Module.fit (parallel/spmd_step.py): "
     "''/0 = off; 'auto'/'all' = a dp mesh over every rank of the process "
     "group; an integer n = the first n ranks (1 is a real one-rank mesh)")
_reg("MXTPU_SPMD_ZERO1", str, "1",
     "ZeRO-1 sharding of the weight update across the dp mesh: each rank "
     "keeps and updates 1/N of the optimizer state; 0 = the all-reduce "
     "baseline (every rank updates everything), bit-equal to it")
_reg("MXTPU_RING_FLASH", str, "1",
     "'0' swaps ring attention's per-hop flash kernel for the plain "
     "per-block softmax (parallel/ring_attention.py)")
_reg("MXTPU_HEARTBEAT_PORT", int, 9099,
     "port of rank 0's heartbeat monitor (parallel/failure.py)")
_reg("MXTPU_SPMD_SHARD_REDUNDANCY", _flag, False,
     "buddy redundancy of the ZeRO-1 optimizer-state shards: each rank "
     "also keeps its ring successor's shard, updated locally from the "
     "summed gradient it already holds (state 1/N -> 2/N, no extra "
     "traffic), so the loss of one rank recovers in memory instead of "
     "from a disk checkpoint (unified_step.UnifiedTrainStep.recover_lost)")

# --- the elastic mesh (parallel/elastic_mesh.py) --------------------------
_reg("MXTPU_MESH_ELASTIC", _flag, True,
     "mesh health monitoring of the sharded SPMD step: every step is "
     "preceded by a one-element sentinel sum over the mesh's dp line on a "
     "watchdog thread, so a dead or stopped rank raises a structured "
     "MeshDegradedError instead of blocking a collective; 0 is the kill "
     "switch (no probe, the fault plan never consulted)")
_reg("MXTPU_MESH_STEP_TIMEOUT_S", float, 60.0,
     "watchdog bound (seconds) on the elastic-mesh sentinel: a probe not "
     "done within it runs the census (a roll call through the group's "
     "store) that names the lost ranks; <=0 skips the probe (injected "
     "kills and hangs still fire)")
_reg("MXTPU_MESH_ON_LOSS", str, "shrink",
     "TrainingSupervisor policy on MeshDegradedError: 'shrink' recovers "
     "the lost shard (buddy copy, else the latest valid checkpoint), bans "
     "the lost ranks and rebuilds the step over the survivors; 'preempt' "
     "writes the bounded final checkpoint and exits 75")

# --- the training driver (train_driver.py) --------------------------------
_reg("MXTPU_DRIVER", _flag, True,
     "the TrainingSupervisor plane: preemption signals, worker "
     "supervision and the anomaly-guard escalation in fit; 0 is the kill "
     "switch")
_reg("MXTPU_PREEMPT_CKPT_TIMEOUT_S", float, 30.0,
     "bound (seconds) on the final checkpoint a preemption writes; past "
     "it the save is abandoned (the MANIFEST commit keeps it invisible)")
_reg("MXTPU_DRIVER_SIGINT", _flag, False,
     "treat SIGINT like a preemption SIGTERM in the TrainingSupervisor")
_reg("MXTPU_DRIVER_BACKOFF_BASE_S", float, 0.2,
     "base of the seeded jittered exponential backoff before a crashed "
     "worker is respawned")
_reg("MXTPU_DRIVER_BACKOFF_MAX_S", float, 5.0,
     "cap on one worker-respawn backoff delay")
_reg("MXTPU_DRIVER_CRASH_WINDOW_S", float, 30.0,
     "sliding window over which worker deaths count toward the "
     "crash-loop breaker")
_reg("MXTPU_DRIVER_CRASH_LIMIT", int, 5,
     "deaths of one worker slot inside the crash window that open the "
     "crash-loop breaker (CrashLoopError)")


_reg("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
     "engine kind: 'NaiveEngine' runs every push synchronously on the "
     "caller's turn (engine.Engine)")
_reg("MXNET_CPU_WORKER_NTHREADS", int, 1,
     "host worker threads: the engine's pool and the native JPEG decode "
     "pool")
_reg("MXTPU_PREFETCH_DEPTH", int, 2,
     "batches PrefetchingIter keeps in flight ahead of the consumer "
     "(io.PrefetchingIter)")
_reg("MXTPU_FAST_DECODE", _flag, True,
     "native JPEG decode with the IFAST DCT and plain chroma upsampling "
     "(about 1 LSB of luma error); 0 decodes exactly (ISLOW)")


_reg("MXTPU_CKPT_DIR", str, "",
     "root directory of the CheckpointManager auto-resume path: set, "
     "Module.fit checkpoints every epoch and resumes from latest_valid() "
     "on restart (params, optimizer states, RNG, epoch); empty = off "
     "(checkpoint.auto_manager)")
_reg("MXTPU_CKPT_KEEP", int, 3,
     "rolling retention: committed checkpoints the CheckpointManager keeps; "
     "older ones (and stale aborted saves) are deleted at each commit")
_reg("MXTPU_CKPT_FAULT_PLAN", str, "",
     "fault_injection.FilePlan spec (e.g. 'kill_before_rename=3') applied "
     "to every atomic checkpoint write in this process; tests only")
_reg("MXTPU_CKPT_COMMIT_DELAY", float, 0.0,
     "seconds slept between writing a checkpoint's data files and "
     "committing its MANIFEST.json, which widens the window a crash test "
     "kills in")


# --- the front end (resource.py, contrib/text) -----------------------------
_reg("MXNET_EXEC_NUM_TEMP", int, 1,
     "round-robin temp-space pool size per context in resource.py")
_reg("MXNET_HOME", str, os.path.join(os.path.expanduser("~"), ".mxnet"),
     "cache root: pre-placed embedding files under embeddings/ "
     "(contrib/text/embedding.py)")

# --- launcher protocol and process group (parallel/distributed.py) --------
_reg("DMLC_ROLE", str, "worker", "launcher process role: under 'server' "
     "with BYTEPS_ENABLE_ASYNC set, importing the package serves the "
     "async parameter server (kvstore_server.py)")
_reg("DMLC_NUM_WORKER", int, 1, "launcher world size")
_reg("DMLC_NUM_SERVER", int, 0, "parameter-server processes the launcher "
     "spawned; > 0 lets dist_async derive the server's address from "
     "DMLC_PS_ROOT_URI (ps_server.resolve_addr)", SUBSUMED)
_reg("MXTPU_NUM_PROCESSES", int, None,
     "multi-process world size; DMLC_NUM_WORKER takes precedence "
     "(parallel/distributed.initialize)")
_reg("MXTPU_PROCESS_ID", int, None,
     "this process's rank; DMLC_WORKER_ID takes precedence "
     "(parallel/distributed.initialize)")

# --- async parameter server (ps_server.py) --------------------------------
_reg("MXTPU_PS_ADDR", str, "",
     "host:port of the async KVStoreServer (overrides the DMLC-derived "
     "address); empty = derive from DMLC_PS_ROOT_URI when a server role "
     "was launched")
_reg("MXTPU_PS_PORT", int, 0,
     "port the async PS binds/dials; 0 = DMLC_PS_ROOT_PORT + 1")
_reg("MXTPU_PS_RETRY_DEADLINE", float, 30.0,
     "seconds a PSClient keeps retrying one request across reconnects "
     "before failing it")
_reg("MXTPU_PS_RETRY_BASE", float, 0.05,
     "base delay of the client's exponential reconnect backoff (jittered)")
_reg("MXTPU_PS_RETRY_MAX", float, 2.0,
     "cap on a single reconnect backoff sleep")
_reg("MXTPU_PS_HEARTBEAT_INTERVAL", float, 2.0,
     "seconds between client liveness heartbeats (side connection); "
     "<= 0 disables the heartbeat thread")
_reg("MXTPU_PS_LEASE_TIMEOUT", float, 10.0,
     "server-side lease: a heartbeating worker silent this long is "
     "presumed dead")
_reg("MXTPU_PS_ROUND_TIMEOUT", float, 120.0,
     "upper bound on any blocked sync round / barrier wait; past it the "
     "server fails the wait with a structured round-timeout error")
_reg("MXTPU_PS_EVICT_DEAD", _flag, False,
     "1 = evict lease-expired workers from sync membership so remaining "
     "workers' rounds complete at the reduced count; default = fail "
     "blocked pulls/barriers with an error naming the dead worker")
_reg("MXTPU_PS_DEDUP_WINDOW", int, 128,
     "per-worker idempotency window: how many state-mutating requests "
     "the server remembers for exactly-once retry replay")
_reg("MXTPU_PS_FAULT_PLAN", str, "",
     "fault_injection.FaultPlan spec (e.g. 'seed=7,duplicate_every=3') "
     "applied to every PSClient created in this process; tests only")
_reg("MXTPU_PS_SNAPSHOT", str, "",
     "path the DMLC_ROLE=server loop restores durable PS state from at "
     "start (if present) and writes it to at exit")
_reg("MXTPU_PS_MAX_STALENESS", int, -1,
     "async-mode SSP bound: a push whose pulled-version of the key is "
     "more than this many versions behind is refused (StalePushError; "
     "the comm plane pulls + retries once), and in block mode a push "
     "that would leave any live member further behind than this blocks "
     "until the laggard pulls; -1 = unbounded staleness (the reference's "
     "BytePS behavior)")
_reg("MXTPU_PS_STALENESS_MODE", str, "refuse",
     "'refuse' = only the pusher's own staleness is policed (stale "
     "pushes get StalePushError); 'block' = additionally hold pushes "
     "that would drop a live laggard past the bound until it catches up")
_reg("MXTPU_PS_ELASTIC_JOIN", _flag, False,
     "1 = a dist_async KVStore joins PS membership at creation (the "
     "cold-join path for workers added to a running job); the epoch "
     "bump triggers resharding on the incumbents at their next "
     "check_epoch()")

# --- gradient communication plane (comm_plane.py) -------------------------
_reg("MXTPU_COMM_BUCKET_BYTES", int, 4 * 1024 * 1024,
     "target size of the dtype-homogeneous flat buffers dense gradients "
     "are bucketed into before the cross-worker collective / PS batch "
     "frame (one comm round per bucket instead of per key); 0 disables "
     "bucketing -- every key takes the per-key path")
_reg("MXTPU_COMM_OVERLAP", _flag, True,
     "run dist/PS kvstore communication on the background comms lane "
     "(push enqueues and returns; pull hands back a pending handle "
     "resolved at the array's next read) so comms overlap compute; 0 = "
     "fully synchronous inline communication")

# --- sparse embedding plane (embedding_plane.py) --------------------------
_reg("MXTPU_EMBED_PLANE", _flag, True,
     "the server-sharded sparse embedding plane: EmbeddingPlane tables "
     "with deferred partial row pulls, row-sparse gradients riding the "
     "PS wire as row payloads, and the PS-path partial row fetch in "
     "KVStore.row_sparse_pull.  0 = kill switch: EmbeddingPlane refuses "
     "to construct and the densifying PS push and local-cache "
     "row_sparse_pull run instead")
_reg("MXTPU_EMBED_VNODES", int, 64,
     "virtual nodes per server shard on the embedding hash ring; the "
     "ring is deterministic in (shard id, vnode index), so elastic "
     "join/leave remaps only the arc the changed shard owned")
_reg("MXTPU_EMBED_PREFETCH", _flag, True,
     "run EmbeddingTable partial pulls on the engine comms lane so the "
     "deferred pull overlaps forward compute; 0 = pull inline at "
     "prefetch()/lookup() time")


# --- profiler (profiler.py) ------------------------------------------------
_reg("MXNET_PROFILER_AUTOSTART", _flag, False,
     "start a capture (torch.profiler, CPU and CUDA activities) at import "
     "of profiler.py")
_reg("MXNET_PROFILER_MODE", int, 0,
     "0 = symbolic ops only, 1 = all (profiler.py aggregate filter)")

# --- serving plane (serving.py) --------------------------------------------
_reg("MXTPU_SERVE_BATCH_LADDER", str, "1,2,4,8,16",
     "ascending padded batch sizes the compiled model pool captures the "
     "forward at; every dispatch is padded up to the smallest rung that "
     "fits (pad rows masked out of responses)")
_reg("MXTPU_SERVE_MAX_BATCH", int, 16,
     "micro-batching queue flushes as soon as this many rows are pending "
     "(the 'full batch' flush); clamped to the top ladder rung")
_reg("MXTPU_SERVE_MAX_DELAY_MS", float, 5.0,
     "micro-batching deadline: the oldest pending request waits at most "
     "this long before the batch flushes part-full (latency bound)")
_reg("MXTPU_SERVE_QUEUE_LIMIT", int, 256,
     "bound on pending ROWS in the micro-batching queue; submits past it "
     "are shed immediately with ServerOverloadError")
_reg("MXTPU_SERVE_RETRY_DEADLINE", float, 10.0,
     "ServeClient reconnect budget: seconds of exponential-backoff retry "
     "after a dropped or poisoned front-door connection; also bounds the "
     "backoff spent honoring a retry_after_ms overload hint")
_reg("MXTPU_SERVE_DRAIN_TIMEOUT", float, 10.0,
     "bound (seconds) on draining a server ahead of a hot swap: queued "
     "rows must flush and in-flight batches complete within it, else "
     "DrainTimeoutError and the old model keeps serving")
_reg("MXTPU_SERVE_PRIORITY", str, "",
     "priority class ServeClient stamps into the infer-frame ctx dict "
     "('low'/'normal'/'high'); empty = no ctx header sent")

# --- fleet serving resilience plane (serving_fleet.py) ---------------------
_reg("MXTPU_SERVE_FLEET", _flag, True,
     "enable the fleet routing tier (serving_fleet.Router); 0 is the kill "
     "switch: Router construction refuses and clients connect straight to "
     "one ModelServer")
_reg("MXTPU_SERVE_HEALTH_INTERVAL", float, 0.5,
     "router active-health-check period: every interval each replica is "
     "pinged and its stats polled (queue depth, p99, model version); probe "
     "outcomes drive the per-replica circuit breaker")
_reg("MXTPU_SERVE_HEALTH_TIMEOUT", float, 2.0,
     "socket timeout on one router health probe; a probe slower than this "
     "counts as a breaker failure")
_reg("MXTPU_SERVE_BREAKER_FAILURES", int, 3,
     "consecutive failures (probe or routed request) that open a "
     "replica's circuit breaker: open = traffic shed away from it")
_reg("MXTPU_SERVE_BREAKER_COOLDOWN_S", float, 2.0,
     "seconds an open breaker waits before going half-open; the next "
     "health probe then closes it (recovery) or re-opens it")
_reg("MXTPU_SERVE_BREAKER_P99_MS", float, 0.0,
     "latency breaker: a replica whose polled p99 exceeds this counts a "
     "breaker failure per health cycle; 0 disables the latency trip")
_reg("MXTPU_SERVE_ROUTER_TIMEOUT", float, 30.0,
     "socket timeout on one routed request; a replica that hangs past it "
     "counts a breaker failure and the request fails over once")
_reg("MXTPU_SERVE_DEPLOY_TIMEOUT", float, 120.0,
     "bound (seconds) on one replica's deploy op during a rolling hot swap "
     "(blob load and the ladder's captures happen inside it)")

# --- autoscale and admission control (autoscale.py) -------------------------
_reg("MXTPU_SERVE_AUTOSCALE", _flag, True,
     "enable the serving-fleet autoscaler (autoscale.Autoscaler); 0 is the "
     "kill switch: Autoscaler construction refuses and the fleet keeps the "
     "size it was built with")
_reg("MXTPU_SERVE_SCALE_UP_QUEUE_ROWS", int, 32,
     "scale-up trigger: mean queued rows per active replica at or above "
     "this spawns a replica (set well below MXTPU_SERVE_QUEUE_LIMIT)")
_reg("MXTPU_SERVE_SCALE_UP_P99_MS", float, 0.0,
     "scale-up trigger: worst active-replica p99 at or above this (ms) "
     "spawns a replica; 0 disables the latency trigger")
_reg("MXTPU_SERVE_SCALE_DOWN_QUEUE_ROWS", int, 2,
     "hysteresis low watermark: the fleet only counts as idle while mean "
     "queued rows per active replica stays at or below this")
_reg("MXTPU_SERVE_SCALE_IDLE_S", float, 10.0,
     "sustained-idle window: seconds the fleet must stay below the down "
     "watermark before one replica is retired")
_reg("MXTPU_SERVE_SCALE_COOLDOWN_S", float, 5.0,
     "minimum seconds between two scale actions in either direction")
_reg("MXTPU_SERVE_MIN_REPLICAS", int, 1,
     "floor the autoscaler never retires below")
_reg("MXTPU_SERVE_MAX_REPLICAS", int, 8,
     "ceiling the autoscaler never spawns above; at the ceiling and still "
     "saturated, the fleet enters brownout")
_reg("MXTPU_SERVE_SCALE_INTERVAL_S", float, 1.0,
     "autoscaler control-loop polling period (jittered +/-20 %, seeded)")
_reg("MXTPU_SERVE_WARMUP_TIMEOUT_S", float, 60.0,
     "bound on a fresh replica's warm-up: it must capture its ladder and "
     "pass a router health probe within this or it is retired unadmitted")
_reg("MXTPU_SERVE_BROWNOUT_DELAY_FACTOR", float, 4.0,
     "brownout: factor MXTPU_SERVE_MAX_DELAY_MS is widened by on every "
     "replica while degraded; restored exactly on exit")
_reg("MXTPU_SERVE_BROWNOUT_RUNG_CAP", int, 0,
     "brownout: cap each replica's flush size to this ladder rung while "
     "degraded; 0 = leave the flush size alone")

# --- generation / continuous batching (generation.py) -----------------------
_reg("MXTPU_GEN_CONTINUOUS", _flag, True,
     "continuous-batching kill switch for the decode lane: 1 fills free "
     "arena slots at every chunk boundary; 0 runs static run-to-completion "
     "batches through the same chunk program")
_reg("MXTPU_GEN_SLOTS", int, 8,
     "decode arena width K: sequences generated at once per DecodeEngine, "
     "fixed at engine build")
_reg("MXTPU_GEN_CHUNK_STEPS", int, 16,
     "decode steps per chunk replay; admission and eviction happen at "
     "chunk boundaries")
_reg("MXTPU_GEN_QUEUE_LIMIT", int, 64,
     "bound on queued generation requests awaiting a free slot; submits "
     "past it are shed with ServerOverloadError (low priority first)")
_reg("MXTPU_GEN_MAX_PROMPT", int, 64,
     "static per-slot prompt buffer length; longer prompts are refused")
_reg("MXTPU_GEN_MAX_TOKENS", int, 256,
     "static per-slot output buffer length: the cap on max_new_tokens")
_reg("MXTPU_GEN_STALL_MS", float, 5000.0,
     "a chunk slower than this (wall ms) records a 'decode_stall' event in "
     "the flight recorder; 0 disables")

# --- telemetry plane (telemetry.py) ----------------------------------------
_reg("MXTPU_TELEMETRY_DIR", str, "",
     "directory the telemetry event stream is mirrored to as one JSONL "
     "file per process (events-<role>-<pid>.jsonl); empty = in-memory ring "
     "only")
_reg("MXTPU_FLIGHT_RECORDER", _flag, True,
     "enable the flight recorder's crash handlers (uncaught-exception hook "
     "and SIGTERM dump); the event ring itself always records")
_reg("MXTPU_FLIGHT_RECORDER_SIZE", int, 512,
     "bound on the flight-recorder ring: most recent events kept per "
     "process (read once at import)")
_reg("MXTPU_FLIGHT_RECORDER_PATH", str, "",
     "file flight-recorder dumps append to; empty = stderr")
_reg("MXTPU_FLIGHT_RECORDER_SIGNALS", _flag, True,
     "install the SIGTERM dump handler (main thread only; re-raises the "
     "default action after dumping)")
_reg("MXTPU_FLIGHT_RECORDER_MIN_INTERVAL_S", float, 5.0,
     "throttle between automatic error-path flight-recorder dumps; 0 = "
     "dump on every structured error")
_reg("MXTPU_SLOW_STEP_WINDOW", int, 32,
     "trailing window (steps) of the Module.fit slow-step watchdog's "
     "baseline median")
_reg("MXTPU_SLOW_STEP_FACTOR", float, 3.0,
     "a step slower than factor x the trailing median emits a structured "
     "slow_step event blaming input vs compute vs comm")
_reg("MXTPU_WORKER_ID", str, "",
     "telemetry worker-id override; empty falls back to DMLC_RANK "
     "(telemetry event tagging)")


def get_env(name: str, default: Optional[Any] = None):
    """Typed env lookup; unregistered names return the raw string (or
    ``default``)."""
    spec = _R.get(name)
    raw = os.environ.get(name)
    if spec is None:
        return raw if raw is not None else default
    if raw is None:
        return default if default is not None else spec.default
    try:
        return spec.type(raw)
    except (TypeError, ValueError):
        return spec.default


def registry() -> Dict[str, EnvVar]:
    """Every registered knob, by name."""
    return dict(_R)


def set_env(name: str, value) -> None:
    os.environ[name] = str(value)


def summary() -> str:
    """A table of every knob, its status and its current value."""
    lines = [f"{'variable':44} {'status':9} value"]
    for name in sorted(_R):
        spec = _R[name]
        lines.append(f"{name:44} {spec.status:9} {get_env(name)!r}")
    return "\n".join(lines)
