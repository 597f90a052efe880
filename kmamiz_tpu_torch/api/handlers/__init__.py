"""REST handlers of the port: every route group of the JAX package's
application (the simulation handler lives in simulator/handler.py)."""
from kmamiz_tpu_torch.api.handlers.alert import AlertHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.comparator import ComparatorHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.configuration import ConfigurationHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.data import DataHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.graph import GraphHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.health import HealthHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.model import ModelHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.swagger import SwaggerHandler  # noqa: F401
from kmamiz_tpu_torch.api.handlers.telemetry import TelemetryHandler  # noqa: F401
