"""REST handlers of the port (the model routes so far)."""
from kmamiz_tpu_torch.api.handlers.model import ModelHandler  # noqa: F401
