"""Ingestion clients: the Zipkin and Kubernetes HTTP APIs.

Counterpart of kmamiz_tpu/ingestion/ (the reference's
src/services/ZipkinService.ts and KubernetesService.ts): the only layer
that talks to the monitored mesh.
"""
from kmamiz_tpu_torch.ingestion.kubernetes import KubernetesClient  # noqa: F401
from kmamiz_tpu_torch.ingestion.zipkin import ZipkinClient  # noqa: F401
