"""paper-scorer — the ~100M likelihood model of the paper's machine phase
(the hybrid human-machine pipeline's 'machine-based method' [25]), used by
the end-to-end examples and the training loop."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-scorer", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=32768, head_dim=64, rope_theta=1e4,
)
