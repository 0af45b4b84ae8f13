"""Llama-3.2-Vision 90B backbone: cross-attention image layers.

[hf:meta-llama/Llama-3.2-90B-Vision; unverified] -- assigned spec:
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Structure: 20
groups of 5 layers, cross-attention at in-group index 0 (20 cross layers
interleaved 1:4 with 80 self-attention layers). The vision frontend is a
STUB per the assignment: ``input_specs()`` provides precomputed ViT patch
embeddings (n=1601 tokens of d=1280, ViT-H scale); the backbone owns only
the multimodal projector.

Copy of ``repro.configs.llama_3_2_vision_90b``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=128256,
    group_size=5,
    cross_index=0,
    n_vision_tokens=1601,
    d_vision=1280,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-3.2-90B-Vision (unverified)",
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    group_size=5,
    cross_index=0,
    n_vision_tokens=16,
    d_vision=32,
    head_pad=1,
    dtype="float32",
)


@register("llama-3.2-vision-90b")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={
            "*": ParallelConfig(fsdp=True),
            "train_4k": ParallelConfig(fsdp=True, microbatches=16, remat="block",
                                       grad_accum_dtype="bfloat16"),
        },
    )
