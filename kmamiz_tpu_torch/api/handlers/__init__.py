"""REST handlers of the port (the graph and model routes so far)."""
from kmamiz_tpu_torch.api.handlers.graph import GraphHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.model import ModelHandler  # noqa: F401
