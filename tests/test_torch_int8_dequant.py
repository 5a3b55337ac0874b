"""The int8 path of the decode kernel dequantizes without the conversion
pipe (``repro_torch/csrc/decode_attention.cu::dequant4``); its steps,
emulated here with numpy bit operations, give ``ref.py::dequantize`` (the
port's plain version) and the reference's bf16 product
(``src/repro/models/layers.py:306-308``) bit for bit, exhaustively: every
int8 value in [-127, 127] (``quantize_kv``'s range) under every positive
finite bf16 scale at or above 1e-8 (``quantize_kv``'s floor), and 0.

The kernel's steps, for a 32-bit word of four int8 values and a scale s:
flip each byte's sign bit (v + 128), permute it into the low mantissa byte
of 2^23, subtract 2^23 + 128 in f32 (exact: v); take each f32's high half
as v in bf16 (exact: at most 7 significant bits, so the low half is 0);
multiply by s with one packed bf16 fma whose addend is -0 (the exact product,
at most 16 significant bits, rounded once to nearest even, which is what
the integer rounding below does to its f32 value; -0 keeps a zero's sign);
widen back to f32 by a shift.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.kernels.decode_attention.ref import dequantize


def _bf16_round(x32: np.ndarray) -> np.ndarray:
    """f32 values to bf16 bits, to nearest even (finite or infinite
    inputs): the fma's rounding of an exact product."""
    bits = x32.view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _kernel_dequant(values: np.ndarray, scale_bits: np.ndarray) -> np.ndarray:
    """``dequant4`` on int8 ``values`` (R, d) with bf16 scale bits (R,):
    bf16 bits (R, d)."""
    b = values.view(np.uint8).astype(np.uint32) ^ 0x80          # v + 128
    f = (np.uint32(0x4B000000) | b).view(np.float32) \
        - np.float32(8388736.0)                                 # exact v
    fb = f.view(np.uint32)
    assert not (fb & 0xFFFF).any()             # v is exact in bf16
    v_bf16 = (fb >> 16).astype(np.uint32)
    s32 = (scale_bits.astype(np.uint32) << 16).view(np.float32)
    v32 = (v_bf16 << 16).view(np.float32)
    with np.errstate(over="ignore"):
        prod = v32 * s32[:, None]              # exact, or past f32's range
    return _bf16_round(prod)


def _scale_bits() -> np.ndarray:
    """Every positive finite bf16 at or above 1e-8, and +0."""
    bits = np.arange(1, 0x7F80, dtype=np.uint32)
    vals = (bits << 16).view(np.float32)
    return np.concatenate([[0], bits[vals >= np.float32(1e-8)]]).astype(
        np.uint16)


def test_integer_dequant_is_the_reference_product_exhaustively():
    scale_bits = _scale_bits()
    assert len(scale_bits) > 19000
    values = np.broadcast_to(np.arange(-127, 128, dtype=np.int8),
                             (len(scale_bits), 255)).copy()
    got = _kernel_dequant(values, scale_bits)
    scale = torch.from_numpy(scale_bits.view(np.int16)).view(torch.bfloat16)
    port = dequantize(torch.from_numpy(values), scale)
    np.testing.assert_array_equal(got.view(np.int16),
                                  port.view(torch.int16).numpy())
    ref = jnp.asarray(values).astype(jnp.bfloat16) \
        * jnp.asarray(scale_bits.view(np.int16)).view(jnp.bfloat16)[:, None]
    np.testing.assert_array_equal(got.view(np.int16),
                                  np.asarray(ref).view(np.int16))
    # the range holds overflows to inf (past bf16's largest finite value)
    assert np.isinf((got.astype(np.uint32) << 16).view(np.float32)).any()


def test_byte_permute_and_packing_follow_the_word_layout():
    """Byte j of a little-endian word is element j, the cache's order: the
    emulated permute of 0x4B into the top byte and the byte into the
    bottom gives 2^23 + (v + 128) for each lane of a word."""
    rng = np.random.default_rng(0)
    values = rng.integers(-127, 128, (64, 16)).astype(np.int8)
    words = values.view(np.uint32)                  # four values a word
    for j in range(4):
        byte = ((words ^ 0x80808080) >> (8 * j)) & 0xFF
        f = (np.uint32(0x4B000000) | byte).view(np.float32) \
            - np.float32(8388736.0)
        np.testing.assert_array_equal(f, values[:, j::4].astype(np.float32))
