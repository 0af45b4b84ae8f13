"""MusicGen-Large: decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Assigned spec: 48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048.
Four EnCodec codebooks (delay pattern applied host-side); the audio
frontend (EnCodec) is a STUB per the assignment -- ``input_specs()``
provides precomputed frame tokens (B, S, 4). Sinusoidal positions as in
the paper.

Copy of ``repro.configs.musicgen_large``, field for field.
"""
from repro_torch.configs import register
from repro_torch.configs.base import ArchBundle, ModelConfig, ParallelConfig

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    pos_embed="sinusoidal",
    source="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=64,
    n_codebooks=4,
    pos_embed="sinusoidal",
    head_pad=1,
    dtype="float32",
)


@register("musicgen-large")
def bundle() -> ArchBundle:
    return ArchBundle(
        model=FULL,
        smoke=SMOKE,
        parallel={"*": ParallelConfig(), "train_4k": ParallelConfig(remat="block", seq_shard_activations=True)},
    )
