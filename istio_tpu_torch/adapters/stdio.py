"""stdio — logs and metrics to stdout/stderr/files as structured lines.

Reference: mixer/adapter/stdio (1,904 LoC, zap-backed). Emits one JSON
line per logentry/metric instance with the reference's field layout
(level, time, instance name, variables). Output stream selectable
(STDOUT/STDERR/file path) with max-days style rotation left to the
platform (files are opened append-only).

Port of istio_tpu/adapters/stdio.py: host code, the reference's own.
"""
from __future__ import annotations

import datetime
import json
import sys
import threading
from typing import Any, IO, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import Builder, Env, Handler, Info

_SEVERITY_LEVELS = {"default": "info", "info": "info", "warning": "warn",
                    "error": "error"}


def _jsonable(v: Any) -> Any:
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, datetime.datetime):
        return v.isoformat()
    if isinstance(v, datetime.timedelta):
        return f"{v.total_seconds()}s"
    if isinstance(v, Mapping):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


class StdioHandler(Handler):
    def __init__(self, config: Mapping[str, Any]):
        stream = config.get("log_stream", "STDOUT")
        self._own_file = False
        if stream == "STDERR":
            self._out: IO[str] = sys.stderr
        elif stream == "STDOUT":
            self._out = sys.stdout
        else:
            self._out = open(stream, "a", encoding="utf-8")
            self._own_file = True
        self.metric_level = config.get("metric_level", "info")
        self._lock = threading.Lock()

    def _emit(self, record: Mapping[str, Any]) -> None:
        line = json.dumps(_jsonable(record), sort_keys=True, default=str)
        with self._lock:
            self._out.write(line + "\n")
            self._out.flush()

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        for inst in instances:
            if template == "logentry":
                sev = str(inst.get("severity", "default")).lower()
                self._emit({
                    "level": _SEVERITY_LEVELS.get(sev, "info"),
                    "time": inst.get("timestamp"),
                    "instance": inst.get("name"),
                    **(inst.get("variables", {}) or {})})
            elif template == "metric":
                self._emit({
                    "level": self.metric_level,
                    "instance": inst.get("name"),
                    "value": inst.get("value"),
                    **(inst.get("dimensions", {}) or {})})

    def close(self) -> None:
        if self._own_file:
            self._out.close()


class StdioBuilder(Builder):
    def build(self) -> Handler:
        return StdioHandler(self.config)


INFO = adapter_registry.register(Info(
    name="stdio",
    supported_templates=("logentry", "metric"),
    builder=StdioBuilder,
    description="logs/metrics to stdout/stderr/files as JSON lines"))
