"""`PTPU_*` environment-switch registry of the PyTorch port.

The same pattern as the JAX package's flag registry: every in-tree read
goes through `env("PTPU_...")` against a declared (type, default,
docstring) entry, so a typo'd flag name raises instead of silently
reading a default. Only the switches the port reads are declared. This
module is stdlib-only so anything in the package can import it.
"""

import os

__all__ = ["EnvFlag", "env", "env_flag"]


def env_flag(name, raw=None):
    """Boolean env parsing shared by every PTPU_* switch: unset/empty ->
    None, 1/true/on/yes -> True, 0/false/off/no -> False
    (case-insensitive), anything else raises naming the flag."""
    raw = os.environ.get(name, "") if raw is None else raw
    if raw == "":
        return None
    low = raw.strip().lower()
    if low in ("1", "true", "on", "yes"):
        return True
    if low in ("0", "false", "off", "no"):
        return False
    raise ValueError("%s=%r is not a boolean flag (use 0/1)" % (name, raw))


class EnvFlag:
    """One declared PTPU_* environment switch: name, type ('bool',
    'int', 'float', 'str', 'path': a path switched off by
    0/false/off/no),
    default (returned when unset/empty), docstring."""

    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name, type, default, doc):
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc

    def parse(self, raw):
        if raw == "":
            return self.default
        if self.type == "bool":
            val = env_flag(self.name, raw)
            return self.default if val is None else val
        if self.type in ("int", "float"):
            conv = int if self.type == "int" else float
            try:
                return conv(raw)
            except ValueError:
                raise ValueError("%s=%r is not %s %s"
                                 % (self.name, raw,
                                    "an" if self.type == "int" else "a",
                                    self.type))
        if self.type == "path" and raw.strip().lower() in (
                "0", "false", "off", "no"):
            return self.default
        return raw


_ENV_REGISTRY = {}


def _declare(name, type, default, doc):
    _ENV_REGISTRY[name] = EnvFlag(name, type, default, doc)


_declare("PTPU_METRICS", "bool", False,
         "enable the instrumented metrics hot paths")
_declare("PTPU_METRICS_OUT", "path", None,
         "dump the metrics registry as JSON to this path at process exit")
_declare("PTPU_METRICS_PORT", "int", None,
         "serve live /metrics, /healthz and /varz on this loopback port "
         "(0 = pick an ephemeral port; unset = no endpoint thread)")
_declare("PTPU_SERVE_ASYNC_STEPS", "int", 4,
         "decode steps kept in flight ahead of EOS/stream materialization")
_declare("PTPU_SERVE_SPEC_K", "int", 0,
         "speculative decoding: draft tokens proposed per serving "
         "decode step and verified in one batched target step "
         "(0 = legacy one-token decode)")
_declare("PTPU_SERVE_SPEC_TREE", "str", None,
         "tree speculation shape 'WxD' (width x depth, e.g. '2x3'): "
         "verify a W-branch token tree of depth D per step via the "
         "in-window tree attention mask; unset/0/off = the linear "
         "PTPU_SERVE_SPEC_K window")
_declare("PTPU_SERVE_PREFILL_CHUNK", "int", 0,
         "chunked prefill: prompt tokens a prefill row consumes per "
         "mixed serving step (0 = legacy one-token prefill)")
_declare("PTPU_SERVE_PREFIX_CACHE", "bool", False,
         "radix prefix caching: share KV blocks across requests with a "
         "common prompt prefix")
_declare("PTPU_SERVE_DRAFT_CHUNK", "int", 16,
         "ModelDrafter catch-up prefill chunk: history tokens a draft row "
         "consumes per draft-side chunk step")
_declare("PTPU_SERVE_DRAFT_MODEL", "path", None,
         "generation-artifact directory of a draft model; when set (and "
         "no drafter is passed) the engine drafts with a ModelDrafter "
         "over it")
_declare("PTPU_ASYNC_STEPS", "int", 12,
         "async in-flight window depth before dispatch backpressures")
_declare("PTPU_NO_PROGRAM_OPT", "bool", False,
         "disable the compile-time pass pipeline (exact unoptimized path)")
_declare("PTPU_AMP", "bool", False,
         "activate the AMP dtype rewrite process-wide")
_declare("PTPU_AMP_LEVEL", "str", "O1",
         "AMP level when activated via PTPU_AMP (O1 or O2)")
_declare("PTPU_AMP_DTYPE", "str", "bfloat16",
         "AMP compute dtype when activated via PTPU_AMP")
_declare("PTPU_AMP_BUCKET_MB", "float", None,
         "gradient-bucket size in MiB for coalesced collectives "
         "(0/unset = per-leaf collectives)")
_declare("PTPU_QUANT", "bool", False,
         "activate the int8 quant_rewrite pass process-wide")
_declare("PTPU_QUANT_MODE", "str", "weight_only",
         "quantization mode when activated via PTPU_QUANT "
         "(weight_only or full_int8)")
_declare("PTPU_QUANT_TABLE", "path", None,
         "calibration-table JSON (quant.CalibrationTable.save) supplying "
         "activation ranges for full_int8")
_declare("PTPU_QUANT_BLACKLIST", "str", None,
         "comma-separated var names whose ops are pinned fp32 by the "
         "quant_rewrite pass")
# -- ZeRO (parallel/zero.py) ------------------------------------------------
_declare("PTPU_ZERO_STAGE", "int", None,
         "ZeRO sharding stage for ShardedAdam (1, 2 or 3)")
_declare("PTPU_ZERO_OVERLAP", "bool", False,
         "issue per-bucket collectives in backward order (comm/compute "
         "overlap)")
_declare("PTPU_ZERO_OFFLOAD", "bool", False,
         "keep optimizer state in host RAM between steps")
# -- the serving fleet and online updates ----------------------------------
_declare("PTPU_SERVE_REPLICAS", "int", 1,
         "ServingRouter engine-replica count (least-loaded dispatch "
         "with health-checked failover across them)")
_declare("PTPU_SERVE_DEADLINE_S", "float", None,
         "per-request serving deadline in seconds: requests past it "
         "fail with DeadlineExceededError at the next step boundary "
         "(unset = wait forever)")
_declare("PTPU_SERVE_RETRY_BUDGET", "int", 3,
         "re-admission attempts the ServingRouter may spend per "
         "request when its replica fails over (exponential backoff; "
         "RetryBudgetExceededError when spent)")
_declare("PTPU_RETRY_BACKOFF", "float", 0.05,
         "base seconds of exponential backoff between transient retries")
_declare("PTPU_SERVE_CANARY_PCT", "float", None,
         "percentage of new requests the ServingRouter pins to the "
         "canary replica while an OnlineUpdater rollout is in its "
         "canary phase (unset = no canary gate)")
_declare("PTPU_ONLINE_POLL_S", "float", 0.25,
         "OnlineUpdater checkpoint-directory poll interval in seconds")
_declare("PTPU_FAULT_INJECT", "str", None,
         "deterministic fault-injection spec, e.g. "
         "'serve_die_at_step:6,ckpt_torn_write:1'")
# -- the resilient trainer and the streaming data plane --------------------
_declare("PTPU_ANOMALY_POLICY", "str", None,
         "ResilientTrainer anomaly policy (warn|skip_batch|rollback|abort; "
         "unset = rollback)")
_declare("PTPU_SPIKE_FACTOR", "float", None,
         "loss-spike threshold as a multiple of the running EMA "
         "(unset = spike detection off)")
_declare("PTPU_RETRY_BUDGET", "int", 8,
         "rollback-and-retry attempts per training run")
_declare("PTPU_DATA_ANOMALY_POLICY", "str", None,
         "corrupt-input containment policy for recordio shard readers "
         "(abort|skip_record|quarantine_shard; unset = skip_record)")
# -- tracing and the flight recorder ----------------------------------------
_declare("PTPU_TRACE", "bool", False,
         "enable tracing-span recording")
_declare("PTPU_TRACE_DIR", "path", None,
         "enable tracing-span recording (the directory a trace is "
         "dumped into)")
_declare("PTPU_BLACKBOX_DIR", "path", None,
         "enable the flight recorder and write its crash dumps "
         "(ptpu_blackbox_*.json) into this directory")
_declare("PTPU_BLACKBOX_EVENTS", "int", None,
         "flight-recorder ring capacity in events (default 4096)")
# -- concurrency analysis ---------------------------------------------------
_declare("PTPU_LOCK_CHECK", "bool", False,
         "route the runtime's named lock sites through tracked "
         "wrappers: lock-order/deadlock detection, "
         "blocking-while-holding checks and the pool/engine invariant "
         "hooks (unset = plain threading primitives, zero overhead)")
_declare("PTPU_LOCK_HOLD_MS", "float", None,
         "with PTPU_LOCK_CHECK=1, report a long-hold violation when a "
         "tracked lock is held longer than this many milliseconds "
         "(unset = off)")


def env(name):
    """Read one declared PTPU_* switch at call time: the parsed value,
    or the declared default when unset/empty. Unknown names raise."""
    spec = _ENV_REGISTRY.get(name)
    if spec is None:
        raise KeyError("undeclared environment flag %r — add it to the "
                       "paddle_tpu_torch.flags registry" % (name,))
    return spec.parse(os.environ.get(name, ""))

