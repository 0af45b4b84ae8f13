"""Qwen3-0.6B: dense GQA with qk-norm. [hf:Qwen/Qwen3-0.6B; hf]

Assigned spec: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

Copy of ``repro.configs.qwen3_0_6b``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-0.6B",
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
    tie_embeddings=True,
    head_pad=1,
    dtype="float32",
)


@register("qwen3-0.6b")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig(), "train_4k": ParallelConfig(remat="block", seq_shard_activations=True)})
