"""dimenet: directional message passing with angular (triplet) basis.
[arXiv:2003.03123; unverified]"""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES

CONFIG = GNNConfig(
    name="dimenet",
    n_blocks=6,
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
    cutoff=5.0,
    envelope_p=6,
    d_out=1,
)

SMOKE = GNNConfig(
    name="dimenet-smoke",
    n_blocks=2,
    d_hidden=32,
    n_bilinear=4,
    n_spherical=3,
    n_radial=4,
    d_out=1,
)

SPEC = ArchSpec(
    arch_id="dimenet",
    family="gnn",
    config=CONFIG,
    shapes=GNN_SHAPES,
    smoke_config=SMOKE,
    source="[arXiv:2003.03123; unverified]",
    notes="Triplet-gather regime (kernel_taxonomy §B.3): RBF/SBF bases + "
          "edge->edge angular messages via segment_sum; non-molecular shapes "
          "use node features -> embedding and a capped triplet budget.",
)
