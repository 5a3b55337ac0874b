"""internlm2-1.8b — GQA dense [arXiv:2403.17297; hf].
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544,
)
