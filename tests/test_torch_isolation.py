"""The port stands alone: every module of istio_tpu_torch imports in a
process where `jax` cannot be imported, `istio_tpu` / `istio_tpu.*` (and
only those) are refused, and neither pyyaml, grpcio, protobuf nor
prometheus_client can be imported (the card's machine has none of
them); and its entry points default to CUDA and raise on a machine
without it instead of running on the CPU."""
import subprocess
import sys
import textwrap

import pytest
import torch

from istio_tpu_torch import resolve_device
from istio_tpu_torch.compiler.layout import InternTable, build_layout
from istio_tpu_torch.compiler.ruleset import Rule, compile_ruleset
from istio_tpu_torch.compiler.tensor_expr import compile_expression
from istio_tpu_torch.interop import manifest_from_reference
from istio_tpu_torch.models.policy_engine import PolicyEngine
from istio_tpu_torch.pilot.discovery import DiscoveryService
from istio_tpu_torch.pilot.route_nfa import RouteScopeProgram, RouteTable
from istio_tpu_torch.pilot.snapshot import build_snapshot
from istio_tpu_torch.runtime import RuntimeServer, SnapshotBuilder
from istio_tpu_torch.testing import workloads


BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "istio_tpu" or name.startswith("istio_tpu."):
                raise ImportError(f"refused: {name}")
            return None

    for absent in ("jax", "yaml", "grpc", "google.protobuf",
                   "prometheus_client"):
        sys.modules[absent] = None
    sys.meta_path.insert(0, Refuse())
    import istio_tpu_torch
    names = ["istio_tpu_torch"]
    for info in pkgutil.walk_packages(istio_tpu_torch.__path__,
                                      "istio_tpu_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    assert not [m for m in sys.modules
                if m == "jax" and sys.modules[m] is not None
                or m == "istio_tpu" or m.startswith("istio_tpu.")]
    print(" ".join(names))
""")


def test_every_module_imports_without_jax_and_istio_tpu():
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 68
    assert {"istio_tpu_torch.compiler.rbac_lower",
            "istio_tpu_torch.adapters.rbac",
            "istio_tpu_torch.ops.route_ops",
            "istio_tpu_torch.pilot.route_nfa",
            "istio_tpu_torch.pilot.discovery",
            "istio_tpu_torch.sharding.planner",
            "istio_tpu_torch.compiler.op_lower",
            "istio_tpu_torch.testing.corpus"} <= set(names)


def test_the_refusing_hook_would_catch_a_leak():
    """Control: the same hook refuses the reference package itself."""
    probe = BLOCKED_IMPORTS.split("import istio_tpu_torch")[0] + \
        "import istio_tpu.attribute.types\n"
    out = subprocess.run([sys.executable, "-c", probe],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "refused: istio_tpu" in out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    finder = workloads.MESH_FINDER
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        PolicyEngine([Rule("r", "")], finder)
    with pytest.raises(RuntimeError, match="CUDA"):
        workloads.make_engine(16)
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_ruleset([Rule("r", "")], finder)
    store = workloads.make_store(4)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            RuntimeServer(store)
        with pytest.raises(RuntimeError, match="CUDA"):
            SnapshotBuilder()
    finally:
        store.close()
    lay = build_layout(dict(workloads.MESH_MANIFEST))
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_expression("true", finder, lay, InternTable())
    services, rules = workloads.make_route_world(20)
    with pytest.raises(RuntimeError, match="CUDA"):
        RouteTable(services, rules)
    with pytest.raises(RuntimeError, match="CUDA"):
        RouteScopeProgram(rules)
    registry, pstore, _, _ = workloads.make_discovery_world(
        n_services=6, n_namespaces=2, replicas=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiscoveryService(registry, pstore)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_snapshot(registry, pstore, version=1)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_manifest_conversion_keeps_names():
    from istio_tpu.testing.corpus import CORPUS_MANIFEST
    got = manifest_from_reference(CORPUS_MANIFEST)
    assert {k: v.name for k, v in got.items()} == \
        {k: v.name for k, v in CORPUS_MANIFEST.items()}
