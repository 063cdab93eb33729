"""Core of the port: the tuned graph index and the modules it composes."""
from repro_torch.core.pipeline import (
    IndexParams, TunedGraphIndex, build_vanilla_nsg,
)

__all__ = ["IndexParams", "TunedGraphIndex", "build_vanilla_nsg"]
