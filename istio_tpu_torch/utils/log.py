"""Scoped structured logging.

Role of the reference's zap-backed ``pkg/log`` (pkg/log/log.go:20-25,
pkg/log/config.go): named scopes, level control per scope, optional JSON
output. Built on stdlib logging so it composes with anything.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any

_FORMAT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s"
_configured = False


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname.lower(),
            "scope": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


# the port's own logger namespace; the JAX package's "istio_tpu" logger
# is never touched (both packages share a process in the tests)
ROOT = "istio_tpu_torch"


def configure_logging(level: str = "info", as_json: bool = False,
                      output_paths: list[str] | None = None) -> None:
    """Configure the port's root logger, ROOT (reference: log.Configure,
    pkg/log/config.go)."""
    global _configured
    root = logging.getLogger(ROOT)
    root.handlers.clear()
    handlers: list[logging.Handler] = []
    for path in output_paths or ["stderr"]:
        if path == "stderr":
            handlers.append(logging.StreamHandler(sys.stderr))
        elif path == "stdout":
            handlers.append(logging.StreamHandler(sys.stdout))
        else:
            handlers.append(logging.FileHandler(path))
    fmt: logging.Formatter = JSONFormatter() if as_json else logging.Formatter(_FORMAT)
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.propagate = False
    _configured = True


def scope(name: str) -> logging.Logger:
    """Return a named logging scope, e.g. scope('runtime')."""
    if not _configured:
        configure_logging()
    return logging.getLogger(f"{ROOT}.{name}")
