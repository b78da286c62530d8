"""Serving: transformer decode over a KV-cache slot pool, the
fusion-aware vertex-function decode, whole-structure scoring and the
cross-request union-frontier engine, hardened by the robustness layer
(lifecycle guards, poison quarantine, degradation ladder on CPU
tensors)."""

from repro_torch.serve.engine import (Request, ServeEngine,
                                      StructureRequest, StructureServeEngine,
                                      VertexRequest, VertexServeEngine)
from repro_torch.serve.continuous import (AdmissionPolicy,
                                          ContinuousBatchEngine,
                                          ContinuousRequest)
from repro_torch.serve.kv_cache import CacheSlots
from repro_torch.serve.robustness import (CircuitBreaker, RequestLifecycle,
                                          TERMINAL, quarantine_bisect,
                                          validate_prompt)

__all__ = ["Request", "ServeEngine", "StructureRequest",
           "StructureServeEngine", "VertexRequest", "VertexServeEngine",
           "AdmissionPolicy", "ContinuousBatchEngine", "ContinuousRequest",
           "CacheSlots", "CircuitBreaker", "RequestLifecycle", "TERMINAL",
           "quarantine_bisect", "validate_prompt"]
