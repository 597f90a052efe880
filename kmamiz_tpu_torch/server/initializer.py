"""The assembled object graph of one instance.

Counterpart of kmamiz_tpu/server/initializer.py, reduced to what the
port's handlers read: the settings and the Data Processor. The store, the
caches and the schedules join it with the handlers that need them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kmamiz_tpu_torch.config import Settings
from kmamiz_tpu_torch.server.processor import DataProcessor


@dataclass
class AppContext:
    settings: Settings = field(default_factory=Settings)
    processor: Optional[DataProcessor] = None
