"""Moonlight-16B-A3B (Moonshot): DeepSeek-style MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf] -- assigned spec:
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
HF config adds: first layer dense (intermediate 11264), 2 shared experts.

Copy of ``repro.configs.moonshot_v1_16b_a3b``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    first_dense_layers=1,
    d_ff_dense=11264,
    n_shared_experts=2,
    rope_theta=50000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=96,
    vocab_size=256,
    n_experts=8,
    top_k=2,
    first_dense_layers=1,
    d_ff_dense=128,
    n_shared_experts=2,
    head_pad=1,
    dtype="float32",
)


@register("moonshot-v1-16b-a3b")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={
            "*": ParallelConfig(fsdp=True),
            "train_4k": ParallelConfig(fsdp=True, microbatches=4, remat="block"),
        },
    )
