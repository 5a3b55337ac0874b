"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
Vision frontend is a STUB: input_specs() ships precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, mrope=True, n_patch_tokens=256,
)
