"""Serving: whole-structure scoring through the schedule pipeline,
hardened by the robustness layer (lifecycle guards, poison quarantine,
degradation ladder on CPU tensors)."""

from repro_torch.serve.engine import StructureRequest, StructureServeEngine
from repro_torch.serve.robustness import (CircuitBreaker, RequestLifecycle,
                                          TERMINAL, quarantine_bisect)

__all__ = ["StructureRequest", "StructureServeEngine", "CircuitBreaker",
           "RequestLifecycle", "TERMINAL", "quarantine_bisect"]
