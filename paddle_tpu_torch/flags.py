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
    'int', 'str', 'path': a path switched off by 0/false/off/no),
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
        if self.type == "int":
            try:
                return int(raw)
            except ValueError:
                raise ValueError("%s=%r is not an int" % (self.name, raw))
        if self.type == "path" and raw.strip().lower() in (
                "0", "false", "off", "no"):
            return self.default
        return raw


_ENV_REGISTRY = {}


def _declare(name, type, default, doc):
    _ENV_REGISTRY[name] = EnvFlag(name, type, default, doc)


_declare("PTPU_METRICS", "bool", False,
         "enable the instrumented metrics hot paths")
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


def env(name):
    """Read one declared PTPU_* switch at call time: the parsed value,
    or the declared default when unset/empty. Unknown names raise."""
    spec = _ENV_REGISTRY.get(name)
    if spec is None:
        raise KeyError("undeclared environment flag %r — add it to the "
                       "paddle_tpu_torch.flags registry" % (name,))
    return spec.parse(os.environ.get(name, ""))

