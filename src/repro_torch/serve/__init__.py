"""Serving: the fusion-aware vertex-function decode, whole-structure
scoring and the cross-request union-frontier engine, hardened by the
robustness layer (lifecycle guards, poison quarantine, degradation
ladder on CPU tensors).  The transformer decode engine and its KV-cache
slots are not ported yet."""

from repro_torch.serve.engine import (StructureRequest, StructureServeEngine,
                                      VertexRequest, VertexServeEngine)
from repro_torch.serve.continuous import (AdmissionPolicy,
                                          ContinuousBatchEngine,
                                          ContinuousRequest)
from repro_torch.serve.robustness import (CircuitBreaker, RequestLifecycle,
                                          TERMINAL, quarantine_bisect)

__all__ = ["StructureRequest", "StructureServeEngine", "VertexRequest",
           "VertexServeEngine", "AdmissionPolicy", "ContinuousBatchEngine",
           "ContinuousRequest", "CircuitBreaker", "RequestLifecycle",
           "TERMINAL", "quarantine_bisect"]
