"""StarCoder2-15B: dense GQA + RoPE. [arXiv:2402.19173; hf]

Assigned spec: 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.

Copy of ``repro.configs.starcoder2_15b``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_head=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_act="gelu",
    rope_theta=100000.0,
    source="arXiv:2402.19173",
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=256,
    vocab_size=256,
    ffn_act="gelu",
    head_pad=1,
    dtype="float32",
)


@register("starcoder2-15b")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={
            "*": ParallelConfig(fsdp=True),
            "train_4k": ParallelConfig(fsdp=True, microbatches=8, remat="block"),
        },
    )
