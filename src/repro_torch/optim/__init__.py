from repro_torch.optim.adamw import (  # noqa: F401
    Optimizer, adamw, clip_by_global_norm, cosine_schedule, global_norm,
    mixed_optimizer, named,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_with_feedback, compression_ratio, init_error_state,
)
