"""Endpoint naming of the simulator.

Copy of kmamiz_tpu/simulator/naming.py:extract_unique_service_name, the
one function the trainer's dataset builder reads.
"""
from __future__ import annotations


def extract_unique_service_name(unique_endpoint_name: str) -> str:
    return "\t".join(unique_endpoint_name.split("\t")[:3])
