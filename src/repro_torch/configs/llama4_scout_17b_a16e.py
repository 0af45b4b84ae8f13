"""Llama-4 Scout 17B-16E: MoE top-1, 16 routed experts + 1 shared.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] -- assigned spec:
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.

Copy of ``repro.configs.llama4_scout_17b_a16e``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    n_experts=4,
    top_k=1,
    n_shared_experts=1,
    head_pad=1,
    dtype="float32",
)


@register("llama4-scout-17b-a16e")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={
            "*": ParallelConfig(fsdp=True),
            "train_4k": ParallelConfig(fsdp=True, microbatches=8, remat="block",
                                       grad_accum_dtype="bfloat16"),
        },
    )
