"""RWKV6 "Finch" 1.6B: attention-free, data-dependent decay.

[arXiv:2404.05892; unverified] -- assigned spec:
24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.

Copy of ``repro.configs.rwkv6_1_6b``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    n_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_lora_decay=64,
    rwkv_lora_mix=32,
    source="arXiv:2404.05892 (unverified)",
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="rwkv",
    n_layers=2,
    d_model=64,
    d_ff=224,
    vocab_size=256,
    rwkv_head_dim=16,
    rwkv_lora_decay=8,
    rwkv_lora_mix=4,
    head_pad=1,
    dtype="float32",
)


@register("rwkv6-1.6b")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={"*": ParallelConfig(), "train_4k": ParallelConfig(remat="block", seq_shard_activations=True)},
    )
