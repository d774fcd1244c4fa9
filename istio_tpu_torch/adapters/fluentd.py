"""fluentd — logentry instances to a fluentd daemon.

Reference: mixer/adapter/fluentd (796 LoC, fluent-logger-golang): sends
[tag, timestamp, record] events with the Fluentd Forward protocol
(msgpack over TCP). The package depends on no msgpack library, so a
minimal encoder for the value shapes we emit (str/bytes/int/float/bool/
None/map/array/datetime→float secs) is included; it implements the
msgpack spec subset the forward protocol needs.

Port of istio_tpu/adapters/fluentd.py: host code, the reference's own.
"""
from __future__ import annotations

import datetime
import socket
import struct
import threading
from typing import Any, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import Builder, Env, Handler, Info


def msgpack_encode(v: Any) -> bytes:
    """Minimal msgpack encoder (spec: msgpack/spec.md fixint/str/map…)."""
    if v is None:
        return b"\xc0"
    if isinstance(v, bool):
        return b"\xc3" if v else b"\xc2"
    if isinstance(v, int):
        if 0 <= v < 128:
            return struct.pack("B", v)
        if -32 <= v < 0:
            return struct.pack("b", v)
        if -(1 << 31) <= v < (1 << 31):
            return b"\xd2" + struct.pack(">i", v)
        return b"\xd3" + struct.pack(">q", v)
    if isinstance(v, float):
        return b"\xcb" + struct.pack(">d", v)
    if isinstance(v, datetime.datetime):
        return msgpack_encode(v.timestamp())
    if isinstance(v, datetime.timedelta):
        return msgpack_encode(v.total_seconds())
    if isinstance(v, bytes):
        return b"\xc4" + struct.pack("B", len(v)) + v if len(v) < 256 \
            else b"\xc5" + struct.pack(">H", len(v)) + v
    if isinstance(v, str):
        raw = v.encode("utf-8")
        if len(raw) < 32:
            return struct.pack("B", 0xa0 | len(raw)) + raw
        if len(raw) < 256:
            return b"\xd9" + struct.pack("B", len(raw)) + raw
        return b"\xda" + struct.pack(">H", len(raw)) + raw
    if isinstance(v, Mapping):
        items = list(v.items())
        if len(items) < 16:
            head = struct.pack("B", 0x80 | len(items))
        else:
            head = b"\xde" + struct.pack(">H", len(items))
        return head + b"".join(msgpack_encode(str(k)) + msgpack_encode(x)
                               for k, x in items)
    if isinstance(v, (list, tuple)):
        if len(v) < 16:
            head = struct.pack("B", 0x90 | len(v))
        else:
            head = b"\xdc" + struct.pack(">H", len(v))
        return head + b"".join(msgpack_encode(x) for x in v)
    return msgpack_encode(str(v))


class FluentdHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env,
                 sock: socket.socket | None = None):
        self.address = (config.get("address", "127.0.0.1"),
                        int(config.get("port", 24224)))
        self._env = env
        self._lock = threading.Lock()
        self._sock = sock
        self._connect_failed = False

    def _send(self, payload: bytes) -> None:
        with self._lock:
            if self._sock is None:
                try:
                    self._sock = socket.create_connection(self.address,
                                                          timeout=1.0)
                except OSError as exc:
                    if not self._connect_failed:
                        self._env.logger.warning(
                            "fluentd connect failed: %s", exc)
                        self._connect_failed = True
                    return
            try:
                self._sock.sendall(payload)
            except OSError as exc:
                self._env.logger.warning("fluentd send failed: %s", exc)
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        for inst in instances:
            tag = str(inst.get("name", "istio"))
            ts = inst.get("timestamp")
            secs = ts.timestamp() if isinstance(ts, datetime.datetime) \
                else datetime.datetime.now(datetime.timezone.utc).timestamp()
            record = {"severity": inst.get("severity", "DEFAULT"),
                      **(inst.get("variables", {}) or {})}
            event = [tag, int(secs), record]
            self._send(msgpack_encode(event))

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


class FluentdBuilder(Builder):
    def build(self) -> Handler:
        return FluentdHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="fluentd",
    supported_templates=("logentry",),
    builder=FluentdBuilder,
    description="logentry to fluentd (forward protocol, msgpack/TCP)"))
