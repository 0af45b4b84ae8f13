"""Jamba-1.5-Large 398B: Mamba+attention 1:7 hybrid with MoE.

[arXiv:2403.19887; hf] -- assigned spec: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2. Jamba block structure: groups of 8
layers with attention at in-group index 4, Mamba elsewhere; MoE FFN every
2nd layer (odd in-group indices).

Copy of ``repro.configs.jamba_1_5_large_398b``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    group_size=8,
    attn_index=4,
    d_state=16,
    d_conv=4,
    expand=2,
    rope_theta=10000.0,
    source="arXiv:2403.19887",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    group_size=8,
    attn_index=4,
    d_state=4,
    d_conv=4,
    expand=2,
    head_pad=1,
    dtype="float32",
)


@register("jamba-1.5-large-398b")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={
            "*": ParallelConfig(fsdp=True, optimizer="adamw", opt_state_dtype="bfloat16"),
            "train_4k": ParallelConfig(
                fsdp=True, microbatches=16, remat="block",
                optimizer="adamw", opt_state_dtype="bfloat16",
                grad_accum_dtype="bfloat16"),
        },
    )
