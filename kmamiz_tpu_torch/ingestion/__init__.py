"""Ingestion clients: the Zipkin HTTP API.

Counterpart of kmamiz_tpu/ingestion/ (the reference's
src/services/ZipkinService.ts); the Kubernetes client is not ported yet.
"""
from kmamiz_tpu_torch.ingestion.zipkin import ZipkinClient  # noqa: F401
