"""SmolLM-135M: llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

Assigned spec: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.

Copy of ``repro.configs.smollm_135m``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_head=64,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=3,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    head_pad=4,
    dtype="float32",
)


@register("smollm-135m")
def bundle() -> ArchBundle:
    return ArchBundle(model=FULL, smoke=SMOKE, parallel={"*": ParallelConfig(), "train_4k": ParallelConfig(remat="block", seq_shard_activations=True)})
