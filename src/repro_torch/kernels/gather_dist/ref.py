"""Plain PyTorch version: gather rows, squared L2 against each query
(the diff-square form of the reference's ``gather_dist/ref.py``)."""
import torch


def gather_dist_ref(queries: torch.Tensor, db: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    rows = db[ids.clamp_min(0)].float()                      # (B, R, D)
    d = ((rows - queries.float()[:, None, :]) ** 2).sum(-1)
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
