"""Config dataclasses (copy of ``repro.configs.base``): model, shape, parallelism, bundle."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | rwkv | snn
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # layer i is MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    first_dense_layers: int = 0      # leading dense layers (moonshot: 1)
    ffn_act: str = "swiglu"          # swiglu | gelu (non-gated, starcoder2)
    n_shared_experts: int = 0
    d_ff_dense: int = 0              # dense-FFN width when mixed with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    tie_embeddings: bool = False
    # attention features
    qk_norm: bool = False
    rope_theta: float = 10000.0
    pos_embed: str = "rope"          # rope | sinusoidal
    head_pad: int = 16               # pad q-heads to this multiple (TP width);
                                     # dead heads are hard-masked (exact)
    # hybrid (jamba)
    group_size: int = 0              # layers per scanned group (jamba 8, vlm 5)
    attn_index: int = -1             # index within group that is attention
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # vlm
    cross_index: int = -1            # index within group that is cross-attn
    n_vision_tokens: int = 0
    d_vision: int = 0
    # audio
    n_codebooks: int = 1
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32
    # snn
    n_neurons: int = 0
    layer_sizes: Tuple[int, ...] = ()
    n_ticks: int = 4
    snn_mode: str = "fixed_leak"
    snn_backend: str = "jnp"         # jnp | pallas | pallas_fused | event (TickEngine)
    snn_dispatch: str = "auto"       # event-backend strategy: auto | fan_in | topk | dense
    snn_density: float = 0.5         # topology density for free-form fabrics
    snn_rate: float = 0.1            # target input spike rate (event operating point)
    snn_chunk_ticks: int = 8         # continuous-admission chunk size (ticks
                                     # per scheduler round; smaller = lower
                                     # TTFT, larger = fewer host/device syncs)
    snn_mesh: int = 0                # devices to shard the fabric over
                                     # (destination columns, DESIGN.md §15);
                                     # 0 = single-device engine
    # numerics
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return i % self.moe_every == self.moe_offset

    @property
    def full_attention(self) -> bool:
        """True when *every* token-mixing layer is quadratic attention
        (drives the long_500k skip rule)."""
        return self.family in ("dense", "moe", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Per-(arch, shape) distribution knobs -- the hillclimb surface."""
    fsdp: bool = False
    seq_shard_activations: bool = False   # Megatron-SP between blocks
    microbatches: int = 1                 # gradient-accumulation steps
    remat: str = "block"                  # none | block | dots
    optimizer: str = "adamw"              # adamw | adafactor
    opt_state_dtype: str = "float32"
    grad_accum_dtype: str = "float32"     # bf16 halves accum memory (>=100B)
    rule_overrides: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    """Everything the launcher needs for one --arch id."""
    model: ModelConfig
    smoke: ModelConfig                       # reduced same-family config
    parallel: Mapping[str, ParallelConfig]   # shape name -> knobs ("*" default)

    def parallel_for(self, shape_name: str) -> ParallelConfig:
        if shape_name in self.parallel:
            return self.parallel[shape_name]
        return self.parallel.get("*", ParallelConfig())


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Assignment rules: long_500k only for sub-quadratic archs; SNN archs
    use their own tick-driven shapes (not the LM set)."""
    if cfg.family == "snn":
        return ()
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.full_attention:
        names.append("long_500k")
    return tuple(names)
