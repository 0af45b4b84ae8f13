"""SmolLM-360M: llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]

Assigned spec: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Copy of ``repro.configs.smollm_360m``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_head=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10000.0,
    source="hf:HuggingFaceTB/SmolLM-360M",
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    head_pad=1,
    dtype="float32",
)


@register("smollm-360m")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig(), "train_4k": ParallelConfig(remat="block", seq_shard_activations=True)})
