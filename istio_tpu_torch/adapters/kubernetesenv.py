"""kubernetesenv — the ATTRIBUTE_GENERATOR adapter: pod metadata.

Reference: mixer/adapter/kubernetesenv (2,613 LoC): a pod-informer
cache keyed by pod UID/IP fills source/destination workload attributes
(pod name, namespace, labels, service account, host IP) during
Preprocess (dispatcher.go:285 → ProcessGenAttrs). The pod cache is a
pluggable `PodSource`: `StaticPodSource` (dict/YAML-file backed) for
hermetic runs, and `InformerPodSource` — a live list+watch cache over
any cluster object with `watch(kind, fn)` / `unwatch(kind, fn)` whose
events carry `.type` and `.obj` (the reference's in-process kube API,
istio_tpu/kube/fake.py, is one), the analog of the reference's
cacheController (kubernetesenv/cache.go) — when the adapter runs
against a cluster. The attribute-production contract is
identical for both.

Port of istio_tpu/adapters/kubernetesenv.py: host code, the reference's
own. The port carries no kube module of its own.
"""
from __future__ import annotations

import threading
from typing import Any, Mapping

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import Builder, Env, Handler, Info

# output attribute suffixes produced per prefix (source/destination/origin)
_OUTPUTS = ("pod_name", "namespace", "labels", "service_account_name",
            "pod_ip", "host_ip", "service")


class StaticPodSource:
    """Pod metadata lookup by `uid` (kubernetes://<pod>.<ns>) or ip."""

    def __init__(self, pods: Mapping[str, Mapping[str, Any]] | None = None):
        self._lock = threading.Lock()
        self._pods = dict(pods or {})
        self._by_ip = {p["pod_ip"]: p for p in self._pods.values()
                       if "pod_ip" in p}

    def update(self, pods: Mapping[str, Mapping[str, Any]]) -> None:
        with self._lock:
            self._pods = dict(pods)
            self._by_ip = {p["pod_ip"]: p for p in self._pods.values()
                           if "pod_ip" in p}

    def by_uid(self, uid: str) -> Mapping[str, Any] | None:
        with self._lock:
            return self._pods.get(uid)

    def by_ip(self, ip: str) -> Mapping[str, Any] | None:
        with self._lock:
            return self._by_ip.get(ip)


class InformerPodSource:
    """Live pod cache over the in-process kube API server.

    kubernetesenv/cache.go's controller role: list+watch Pods, keep
    uid- and ip-keyed indexes current, and answer lookups from the
    local cache (never the API server) on the request path. The
    canonical workload "service" attribute is derived from the `app`
    label (kubernetesenv's canonical-service resolution order:
    explicit annotation → app label → pod name prefix).
    """

    def __init__(self, cluster) -> None:
        self._lock = threading.Lock()
        self._pods: dict[str, dict[str, Any]] = {}     # "<name>.<ns>" →
        self._by_ip: dict[str, dict[str, Any]] = {}
        self._cluster = cluster
        cluster.watch("Pod", self._on_event)

    def close(self) -> None:
        """Deregister from the cluster — handlers are rebuilt per
        config signature and stale informers must not keep indexing."""
        self._cluster.unwatch("Pod", self._on_event)

    @staticmethod
    def _to_entry(obj: Mapping[str, Any]) -> dict[str, Any]:
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        labels = dict(meta.get("labels") or {})
        entry: dict[str, Any] = {
            "pod_name": str(meta.get("name", "")),
            "namespace": str(meta.get("namespace", "")),
            "labels": labels,
        }
        if spec.get("serviceAccountName"):
            entry["service_account_name"] = str(spec["serviceAccountName"])
        if status.get("podIP"):
            entry["pod_ip"] = str(status["podIP"])
        if status.get("hostIP"):
            entry["host_ip"] = str(status["hostIP"])
        service = labels.get("app") or str(meta.get("name", ""))
        if service:
            entry["service"] = str(service)
        return entry

    def _on_event(self, ev) -> None:
        meta = ev.obj.get("metadata") or {}
        uid = f"{meta.get('name', '')}.{meta.get('namespace', '')}"
        with self._lock:
            old = self._pods.pop(uid, None)
            if old is not None and "pod_ip" in old:
                self._by_ip.pop(old["pod_ip"], None)
            if ev.type != "DELETED":
                entry = self._to_entry(ev.obj)
                self._pods[uid] = entry
                if "pod_ip" in entry:
                    self._by_ip[entry["pod_ip"]] = entry

    def by_uid(self, uid: str) -> Mapping[str, Any] | None:
        with self._lock:
            return self._pods.get(uid)

    def by_ip(self, ip: str) -> Mapping[str, Any] | None:
        with self._lock:
            return self._by_ip.get(ip)


class KubernetesEnvHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env):
        if config.get("pod_source") is not None:
            self.source = config["pod_source"]
        elif config.get("cluster") is not None:
            self.source = InformerPodSource(config["cluster"])
        else:
            self.source = StaticPodSource(config.get("pods", {}))

    def close(self) -> None:
        source_close = getattr(self.source, "close", None)
        if source_close is not None:
            source_close()

    def generate_attributes(self, template: str,
                            instance: Mapping[str, Any]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for prefix in ("source", "destination", "origin"):
            pod = None
            uid = instance.get(f"{prefix}_uid")
            if uid:
                pod = self.source.by_uid(str(uid).removeprefix(
                    "kubernetes://"))
            if pod is None:
                ip = instance.get(f"{prefix}_ip")
                if ip is not None:
                    import ipaddress
                    if isinstance(ip, bytes):
                        ip = str(ipaddress.ip_address(
                            ip[-4:] if len(ip) == 16 and
                            ip[:12] == b"\x00" * 10 + b"\xff\xff" else ip))
                    pod = self.source.by_ip(str(ip))
            if pod is None:
                continue
            for key in _OUTPUTS:
                if key in pod:
                    out[f"{prefix}_{key}"] = pod[key]
        return out


class KubernetesEnvBuilder(Builder):
    def build(self) -> Handler:
        return KubernetesEnvHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="kubernetesenv",
    supported_templates=("kubernetes",),
    builder=KubernetesEnvBuilder,
    description="pod-metadata attribute generator (APA)"))
