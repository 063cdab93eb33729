"""The paper's black-box tuner (§3.2): search space, samplers, study and
the ANN objective."""
from repro_torch.core.tuning.objective import (  # noqa: F401
    DEFAULT_ALPHA_GRID, AnnObjective, EvalResult, SearchParamsObjective,
    ShardedRepruneObjective, default_space, snap_alpha,
)
from repro_torch.core.tuning.samplers import (  # noqa: F401
    RandomSampler, TPESampler,
)
from repro_torch.core.tuning.space import (  # noqa: F401
    Categorical, Float, Int, SearchSpace,
)
from repro_torch.core.tuning.study import Study, Trial  # noqa: F401
