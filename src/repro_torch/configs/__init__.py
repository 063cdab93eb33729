"""Configurations of the port (the ANN workload only, so far)."""
from repro_torch.configs.base import ANNConfig, ShapeConfig

__all__ = ["ANNConfig", "ShapeConfig"]
