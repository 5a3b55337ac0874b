"""rwkv6-3b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892; hf].
32L d_model=2560 d_ff=8960 vocab=65536."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65536, rwkv=True,
)
