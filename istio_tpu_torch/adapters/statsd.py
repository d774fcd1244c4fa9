"""statsd — metrics to a statsd daemon over UDP.

Reference: mixer/adapter/statsd (1,351 LoC, go-statsd-client): each
metric instance maps to a statsd counter/gauge/timing with an optional
name template over the dimensions. UDP datagrams use the classic
`name:value|type[|@rate]` line protocol; sends are fire-and-forget
exactly like the reference.

Port of istio_tpu/adapters/statsd.py: host code, the reference's own.
"""
from __future__ import annotations

import socket
import string
from typing import Any, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import Builder, Env, Handler, Info

_TYPE_CODE = {"COUNTER": "c", "GAUGE": "g", "TIMING": "ms"}


class StatsdHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env,
                 sock: socket.socket | None = None):
        self.address = (config.get("address", "127.0.0.1"),
                        int(config.get("port", 8125)))
        self.prefix = config.get("prefix", "")
        self._sock = sock or socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._metrics: dict[str, Mapping[str, Any]] = {
            m["name"]: m for m in config.get("metrics", ())}
        self._env = env

    def _name_for(self, inst: Mapping[str, Any],
                  spec: Mapping[str, Any]) -> str:
        tmpl = spec.get("name_template", "")
        base = inst.get("name", "")
        if tmpl:
            dims = {k: str(v)
                    for k, v in (inst.get("dimensions", {}) or {}).items()}
            base = string.Template(tmpl).safe_substitute(dims)
        return self.prefix + base

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        for inst in instances:
            spec = self._metrics.get(inst.get("name", ""))
            if spec is None:
                continue
            code = _TYPE_CODE.get(spec.get("type", "COUNTER"), "c")
            value = inst.get("value", 0)
            if isinstance(value, bool):
                value = int(value)
            line = f"{self._name_for(inst, spec)}:{value}|{code}"
            rate = spec.get("sample_rate")
            if rate is not None:
                line += f"|@{rate}"
            try:
                self._sock.sendto(line.encode("utf-8"), self.address)
            except OSError as exc:   # fire-and-forget
                self._env.logger.warning("statsd send failed: %s", exc)

    def close(self) -> None:
        self._sock.close()


class StatsdBuilder(Builder):
    def validate(self) -> list[str]:
        errs = []
        for m in self.config.get("metrics", ()):
            if m.get("type", "COUNTER") not in _TYPE_CODE:
                errs.append(f"{m.get('name')}: unknown type")
        return errs

    def build(self) -> Handler:
        return StatsdHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="statsd",
    supported_templates=("metric",),
    builder=StatsdBuilder,
    description="metrics to statsd over UDP"))
