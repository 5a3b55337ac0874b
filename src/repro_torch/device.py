"""Device choice and float precision for the whole port.

Every entry point of :mod:`repro_torch` takes a ``device`` argument and runs
on the card unless the caller asks for ``"cpu"`` (which the tests do).  TF32
stays off: it keeps about three decimal digits of each f32 product, enough
to move a cosine score across the candidate threshold and so change the
candidate set.  bf16 matrix products accumulate in f32 without reduced
precision reductions, as XLA's do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_precision() -> None:
    """Full-f32 matrix products and convolutions (TF32 off); bf16 products
    reduce in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def pick_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when the card is asked for and none is present —
    the port never drops to the CPU on its own."""
    set_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one, a bare ``cuda`` being the current
    card."""
    def resolved(d: torch.device) -> torch.device:
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return a.type == b.type and (a.type != "cuda"
                                 or resolved(a) == resolved(b))
