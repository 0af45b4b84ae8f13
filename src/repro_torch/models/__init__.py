from repro_torch.models import attention, common, ffn, model, rwkv, ssm, transformer

__all__ = ["attention", "common", "ffn", "model", "rwkv", "ssm", "transformer"]
