"""Static verification of served predicate planes.

Port of the part of istio_tpu/analysis that the mesh audit plane's
plane-agreement check (runtime/audit.py) runs: the finding vocabulary
(`findings`), product-DFA decisions over ops/regex_dfa tables
(`dfa_ops`), atom semantics and witness solving (`atoms`), the DNF
reasoning over the compiler's own decomposition (`reach`) and the
Pilot-vs-Mixer pair checker (`planes.check_plane_pairs`). The snapshot
analyzer, its budget model and meshlint are not ported.
"""
from istio_tpu_torch.analysis.findings import (AnalysisReport, Finding,
                                               Severity)
from istio_tpu_torch.analysis.planes import check_plane_pairs

__all__ = ["AnalysisReport", "Finding", "Severity", "check_plane_pairs"]
