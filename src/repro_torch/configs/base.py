"""Config dataclasses of the port (copied from the reference's
``configs/base.py``): the dense / MoE decoder LM, the paper's ANN workload,
the recsys family, DimeNet's GNN config and the ``ArchSpec`` the launchers
select by ``--arch``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class LMConfig:
    """Dense / MoE decoder-only transformer (covers GQA, qk-norm, MLA, MoE).

    Every field of the reference's, with its meaning: the port's model
    runs GQA and MLA attention, dense and MoE FFNs."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MLA (DeepSeek-V2 multi-head latent attention) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0          # per-expert FFN width
    first_dense_layers: int = 0  # leading dense layers (DeepSeek style)
    dense_d_ff: int = 0          # FFN width of those leading dense layers
    router_aux_loss: float = 0.001
    moe_capacity_factor: float = 1.25  # GShard capacity (tokens may drop)
    moe_group_size: int = 1024         # dispatch group (bounds one-hot mem)
    dtype: str = "bfloat16"
    # True when attention is O(seq^2) with no sub-quadratic mode in the
    # published config; gates the long_500k cell
    full_attention: bool = True

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.n_heads * (self.qk_nope_head_dim
                                   + self.qk_rope_head_dim)
        return self.n_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (MODEL_FLOPS = 6ND): embeddings, then
        each layer's attention and FFN; norms and biases not counted."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.use_mla:
            q = (d * self.q_lora_rank + self.q_lora_rank * self.q_dim
                 ) if self.q_lora_rank else d * self.q_dim
            kv = (d * (self.kv_lora_rank + self.qk_rope_head_dim)
                  + self.kv_lora_rank * self.n_heads
                  * (self.qk_nope_head_dim + self.v_head_dim))
            o = self.n_heads * self.v_head_dim * d
            attn = q + kv + o
        else:
            attn = (d * self.n_heads * self.head_dim          # Q
                    + 2 * d * self.n_kv_heads * self.head_dim  # K,V
                    + self.n_heads * self.head_dim * d)        # O
        dense_ffn = 3 * d * self.d_ff
        per_layer = []
        for layer in range(L):
            if self.moe and layer >= self.first_dense_layers:
                ffn = (self.n_routed_experts + self.n_shared_experts) \
                    * 3 * d * self.moe_d_ff + d * self.n_routed_experts
            elif self.moe:
                ffn = 3 * d * (self.dense_d_ff or self.d_ff)
            else:
                ffn = dense_ffn
            per_layer.append(attn + ffn)
        return emb + sum(per_layer)

    def active_param_count(self) -> int:
        """Activated params per token (MoE-aware), for 6·N_active·D."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        moe_layers = L - self.first_dense_layers
        inactive_experts = self.n_routed_experts - self.moe_top_k
        return full - moe_layers * inactive_experts * 3 * d * self.moe_d_ff


@dataclass(frozen=True)
class GNNConfig:
    """DimeNet-style directional message-passing network."""

    name: str
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    envelope_p: int = 6
    d_out: int = 1
    dtype: str = "float32"


@dataclass(frozen=True)
class RecsysConfig:
    """Sparse-embedding + interaction + MLP ranking/retrieval models."""

    name: str
    interaction: str                 # dot | self-attn-seq | target-attn
    embed_dim: int
    table_vocabs: Tuple[int, ...]    # rows per sparse embedding table
    n_dense: int = 0                 # dense (numeric) features
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    tower_mlp: Tuple[int, ...] = ()  # two-tower
    attn_mlp: Tuple[int, ...] = ()   # DIN local activation unit
    seq_len: int = 0                 # behaviour-sequence length
    n_blocks: int = 0                # sasrec transformer blocks
    n_heads: int = 0
    multi_hot: Tuple[int, ...] = ()  # bag size per table (1 = one-hot)
    dtype: str = "float32"

    @property
    def n_sparse(self) -> int:
        return len(self.table_vocabs)


@dataclass(frozen=True)
class ANNConfig:
    """The paper's workload: tuned graph index over D0-dim embeddings."""

    name: str
    dim: int = 768                   # D0 (LAION CLIP dim)
    n_database: int = 300_000
    k: int = 10
    # --- the paper's three tunable knobs + search width ---
    pca_dim: int = 768               # D  (<= dim)
    antihub_keep: float = 1.0        # alpha
    ep_clusters: int = 1             # k-means entry points (1 = medoid)
    ef_search: int = 64              # beam width
    # --- graph build ---
    graph_degree: int = 32           # R (NSG out-degree budget)
    build_knn_k: int = 32
    build_candidates: int = 64       # MRNG candidate pool L
    prune_alpha: float = 1.0         # α-RNG occlusion slack (1.0 = MRNG)
    knn_backend: str = "auto"        # exact | nndescent | auto (core.build)
    finish_backend: str = "auto"     # host | device | auto (build.finish)
    dist_backend: str = "f32"        # f32 | pq | int8 (core.quant serving)
    pq_m: int = 0                    # PQ sub-quantizers (0 = auto by dim)
    rerank: int = 64                 # exact-rerank depth of quantized tail
    hop_backend: str = "auto"        # staged | fused | auto (beam hop)
    patience: int = 0                # adaptive-termination hops (0 = off)
    eps: float = 0.0                 # top-k progress threshold for patience
    compact_every: int = 0           # compaction slice length (0 = off)
    dtype: str = "float32"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode | serve | retrieval | graph
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    n_triplets: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0    # batched small graphs
    # Recsys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", seq_len=4096,
                            global_batch=256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", seq_len=32768,
                               global_batch=32),
    "decode_32k": ShapeConfig("decode_32k", "decode", seq_len=32768,
                              global_batch=128),
    "long_500k": ShapeConfig("long_500k", "decode", seq_len=524288,
                             global_batch=1),
}

# Triplet capacity: DimeNet's angular messages live on (kj->ji) wedges. For
# molecular graphs this is ~deg^2 per node; for the big web/product graphs the
# budget is capped at 2 triplets/edge (fine-grained angular sampling). The
# sampler (data/graph_sampler.py) keeps to the cap.
GNN_SHAPES: Dict[str, ShapeConfig] = {
    "full_graph_sm": ShapeConfig(
        "full_graph_sm", "train", n_nodes=2708, n_edges=10556,
        n_triplets=42224, d_feat=1433),
    "minibatch_lg": ShapeConfig(
        "minibatch_lg", "train", n_nodes=171_008, n_edges=168_960,
        n_triplets=337_920, d_feat=602, batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": ShapeConfig(
        "ogb_products", "train", n_nodes=2_449_029, n_edges=61_859_140,
        n_triplets=123_718_280, d_feat=100),
    "molecule": ShapeConfig(
        "molecule", "train", n_nodes=30, n_edges=64, n_triplets=256,
        d_feat=0, n_graphs=128),
}

RECSYS_SHAPES: Dict[str, ShapeConfig] = {
    "train_batch": ShapeConfig("train_batch", "train", batch=65536),
    "serve_p99": ShapeConfig("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeConfig("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeConfig(
        "retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
}


@dataclass(frozen=True)
class ArchSpec:
    """Everything the launchers need for one ``--arch`` id."""

    arch_id: str
    family: str                      # lm | gnn | recsys | ann
    config: Any                      # LMConfig | GNNConfig | RecsysConfig |
                                     # ANNConfig
    shapes: Dict[str, ShapeConfig]
    smoke_config: Any = None         # reduced same-family config, if any
    source: str = ""                 # [citation; verification tier]
    notes: str = ""

    def shape(self, name: str) -> ShapeConfig:
        return self.shapes[name]

    def skip_reason(self, shape_name: str) -> Optional[str]:
        """A reason string if this (arch, shape) cell must be skipped: an
        LM whose published config is pure full attention skips
        long_500k."""
        if self.family == "lm" and shape_name == "long_500k":
            if getattr(self.config, "full_attention", True):
                return ("long_500k needs sub-quadratic attention; "
                        f"{self.arch_id} is pure full-attention per its "
                        "published config")
        return None


def reduced_lm(cfg: LMConfig, **overrides) -> LMConfig:
    """Tiny same-family LM for CPU smoke tests (keeps every flag; f32)."""
    base = dict(
        name=cfg.name + "-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
        head_dim=16, d_ff=128, vocab_size=503,
        qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta,
        tie_embeddings=cfg.tie_embeddings, use_mla=cfg.use_mla,
        kv_lora_rank=32 if cfg.use_mla else 0,
        q_lora_rank=48 if (cfg.use_mla and cfg.q_lora_rank) else 0,
        qk_nope_head_dim=16 if cfg.use_mla else 0,
        qk_rope_head_dim=8 if cfg.use_mla else 0,
        v_head_dim=16 if cfg.use_mla else 0,
        moe=cfg.moe,
        n_routed_experts=8 if cfg.moe else 0,
        n_shared_experts=min(cfg.n_shared_experts, 2) if cfg.moe else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe else 0,
        moe_d_ff=64 if cfg.moe else 0,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        dense_d_ff=128 if cfg.moe else 0,
        moe_capacity_factor=8.0,   # no token drops in smoke tests
        moe_group_size=64,
        dtype="float32", full_attention=cfg.full_attention,
    )
    base.update(overrides)
    return LMConfig(**base)
