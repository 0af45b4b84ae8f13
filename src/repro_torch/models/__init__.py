from repro_torch.models import attention, common, ffn, model, transformer

__all__ = ["attention", "common", "ffn", "model", "transformer"]
