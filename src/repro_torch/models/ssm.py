"""State-space and linear-recurrence blocks of the port: Mamba2 (the
chunked SSD) and RWKV6 ("Finch": token shift and a data-dependent decay),
each with a parallel form for training and prefill and an O(1)-a-token
decode step.  A port of the JAX package's ``models/ssm.py``, function for
function and with the same names.

No hand-written kernel here: the reference computes the SSD and the WKV
time scan with ``jnp`` einsums and ``lax.scan``, outside any Pallas kernel,
and the port computes them with plain PyTorch on both devices, as it does
its matrix products.  The arithmetic and the casts are the reference's:

* ``mamba2_ssd`` takes the chunk length Q as the largest divisor of S that
  is at most ``ssm_chunk`` (a prime S gives Q = 1), since another Q sums in
  another order.  The diagonal blocks multiply in the input's dtype; the
  chunk states, the inter-chunk recurrence (a loop over chunks, as the
  reference's ``lax.scan``) and the off-diagonal term stay f32.
* ``_rwkv_wkv_scan`` is a loop over time steps of the outer-product
  recurrence in f32.
* ``torch.nn.functional.softplus`` (beta 1, threshold 20) and
  ``jax.nn.softplus`` (``logaddexp(x, 0)``) agree in f32: past 20,
  ``log1p(exp(-x)) < 2.1e-9`` is below half an ulp of x, so both return x.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ParamSpec, Specs, rmsnorm

_F32 = torch.float32


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================
def mamba2_specs(cfg: ModelConfig) -> Specs:
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.n_ssm_heads
    G = 1
    conv_dim = di + 2 * G * N
    in_dim = 2 * di + 2 * G * N + H
    return {
        "in_proj": ParamSpec((d, in_dim), ("embed", "ssm_inner"), fan_in=d),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "ssm_inner"),
                            fan_in=cfg.ssm_conv),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), fan_in=0),
        "A_log": ParamSpec((H,), (None,), fan_in=0),
        "D": ParamSpec((H,), (None,), fan_in=0),
        "dt_bias": ParamSpec((H,), (None,), fan_in=0),
        "norm": ParamSpec((di,), ("ssm_inner",), fan_in=0),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), fan_in=di),
    }


def _split_zxbcdt(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    B_ = zxbcdt[..., 2 * di:2 * di + N]
    C_ = zxbcdt[..., 2 * di + N:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, x, B_, C_, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, f32 inside. xbc: (B, S, Cd), w: (k, Cd)."""
    k = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=_F32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + S].to(_F32) * w[i].to(_F32)
    out = out + b.to(_F32)
    return F.silu(out).to(xbc.dtype)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Q) -> (..., Q, Q) lower-triangular pairwise sums:
    out[q, s] = sum_{s < i <= q} dA[i] (q >= s), -inf above the diagonal.
    The difference is finite everywhere and ``torch.where`` only picks
    -inf above the diagonal, so ``exp`` of it has a gradient of 0 there
    and never NaN."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]    # [q, s] = cs[q] - cs[s]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunk(S: int, ssm_chunk: int) -> int:
    """The SSD's chunk length: the largest divisor of S that is at most
    ``ssm_chunk`` (1 for a prime S past it)."""
    Q = min(ssm_chunk, S)
    while S % Q:
        Q -= 1
    return Q


def mamba2_ssd(x, dt, A, B_, C_, D, cfg: ModelConfig):
    """Chunked SSD.  x: (B, S, H, P); dt: (B, S, H); A: (H,);
    B_, C_: (B, S, N) (one group, broadcast over heads).  Returns
    (y (B, S, H, P) in x's dtype, the final state (B, H, N, P) f32)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = ssd_chunk(S, cfg.ssm_chunk)
    nc = S // Q
    dtf = dt.to(_F32)
    dA = dtf * A.to(_F32)                                  # (B,S,H)
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dtf.reshape(Bsz, nc, Q, H)
    dAc = dA.reshape(Bsz, nc, Q, H)
    Bc = B_.reshape(Bsz, nc, Q, N)
    Cc = C_.reshape(Bsz, nc, Q, N)

    # intra-chunk (diagonal blocks): Y_diag = (C_q . B_s) L[q, s] dt_s x_s,
    # multiplied in the input's dtype
    Lmat = torch.exp(_segsum(dAc.movedim(-1, -2)))        # (B,nc,H,Q,Q)
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)          # (B,nc,Q,Q)
    scores = cb[:, :, None] * Lmat                        # (B,nc,H,Q,Q) f32
    xdt = xc * dtc[..., None]                             # (B,nc,Q,H,P) f32
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores.to(x.dtype),
                          xdt.to(x.dtype))

    # chunk states: state_c = sum_s exp(cum_last - cum_s) B_s (dt_s x_s),
    # in f32 (the inter-chunk recurrence compounds rounding error)
    cum = torch.cumsum(dAc, dim=2)                        # (B,nc,Q,H)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcshp->bchnp", Bc.to(_F32),
                          xdt * decay_states[..., None])

    # inter-chunk recurrence over nc chunks, each chunk reading the state
    # before it
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)
    prev = torch.zeros((Bsz, H, N, P), dtype=_F32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)               # (B,nc,H,N,P)

    # off-diagonal contribution: Y_off[q] = C_q . prev_state * exp(cum_q)
    state_decay = torch.exp(cum)                          # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bchnp->bcqhp", Cc.to(_F32), prev_states)
    y_off = y_off * state_decay[..., None]

    y = (y_diag.to(_F32) + y_off).reshape(Bsz, S, H, P)
    y = y + x.to(_F32) * D.to(_F32)[None, None, :, None]
    return y.to(x.dtype), prev


def mamba2_block(x, p, cfg: ModelConfig, return_state: bool = False):
    """The Mamba2 mixer.  x: (B, S, d) -> (B, S, d) [, (the SSM state
    (B, H, N, P) f32, the conv state: the last k - 1 pre-conv rows
    (B, k - 1, conv_dim) in x's dtype)]."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xin, B_, C_, dt = _split_zxbcdt(zxbcdt, cfg)
    xbc_pre = torch.cat([xin, B_, C_], dim=-1)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"])
    xin, B_, C_ = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt.to(_F32) + p["dt_bias"].to(_F32))
    A = -torch.exp(p["A_log"].to(_F32))
    xh = xin.reshape(*xin.shape[:2], H, P)
    y, final_state = mamba2_ssd(xh, dt, A, B_, C_, p["D"], cfg)
    y = y.reshape(*x.shape[:2], di)
    y = rmsnorm(y * F.silu(z.to(_F32)).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        conv_state = xbc_pre[:, -(cfg.ssm_conv - 1):]
        return out, (final_state.to(_F32), conv_state)
    return out


def mamba2_decode_step(x, p, cfg: ModelConfig, ssm_state, conv_state):
    """x: (B, 1, d); ssm_state: (B, H, N, P); conv_state:
    (B, k - 1, conv_dim).  Returns (y, new ssm_state in ssm_state's dtype,
    new conv_state); the states given are not written."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xin, B_, C_, dt = _split_zxbcdt(zxbcdt, cfg)
    xbc_new = torch.cat([xin, B_, C_], dim=-1)            # (B,1,conv_dim)
    window = torch.cat([conv_state, xbc_new], dim=1)      # (B,k,conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", window.to(_F32),
                            p["conv_w"].to(_F32)) + p["conv_b"].to(_F32)
    xbc = F.silu(conv_out)[:, None].to(x.dtype)
    xin, B_, C_ = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt.to(_F32) + p["dt_bias"].to(_F32))  # (B,1,H)
    A = -torch.exp(p["A_log"].to(_F32))
    dA = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
    xh = xin.reshape(x.shape[0], H, P)
    dBx = torch.einsum("bn,bhp->bhnp", B_[:, 0].to(_F32),
                       dt[:, 0, :, None] * xh.to(_F32))
    new_state = ssm_state.to(_F32) * dA + dBx
    y = torch.einsum("bn,bhnp->bhp", C_[:, 0].to(_F32), new_state)
    y = y + xh.to(_F32) * p["D"].to(_F32)[None, :, None]
    y = y.reshape(x.shape[0], 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z.to(_F32)).to(y.dtype), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], new_state.to(ssm_state.dtype), window[:, 1:]


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================
def rwkv6_specs(cfg: ModelConfig) -> Specs:
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rwkv_decay_rank
    H = d // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    return {
        # time-mix
        "mu_r": ParamSpec((d,), (None,), fan_in=0),
        "mu_k": ParamSpec((d,), (None,), fan_in=0),
        "mu_v": ParamSpec((d,), (None,), fan_in=0),
        "mu_w": ParamSpec((d,), (None,), fan_in=0),
        "mu_g": ParamSpec((d,), (None,), fan_in=0),
        "w_r": ParamSpec((d, d), ("embed", "qheads"), fan_in=d),
        "w_k": ParamSpec((d, d), ("embed", "qheads"), fan_in=d),
        "w_v": ParamSpec((d, d), ("embed", "qheads"), fan_in=d),
        "w_g": ParamSpec((d, d), ("embed", "qheads"), fan_in=d),
        "w_o": ParamSpec((d, d), ("qheads", "embed"), fan_in=d),
        "w0": ParamSpec((d,), (None,), fan_in=0),
        "wA": ParamSpec((d, r), ("embed", None), fan_in=d),
        "wB": ParamSpec((r, d), (None, "qheads"), fan_in=r),
        "bonus_u": ParamSpec((H, hd), (None, None), fan_in=0),
        "ln_x": ParamSpec((d,), (None,), fan_in=0),
        # channel-mix
        "mu_ck": ParamSpec((d,), (None,), fan_in=0),
        "mu_cr": ParamSpec((d,), (None,), fan_in=0),
        "w_ck": ParamSpec((d, f), ("embed", "mlp"), fan_in=d),
        "w_cv": ParamSpec((f, d), ("mlp", "embed"), fan_in=f),
        "w_cr": ParamSpec((d, d), ("embed", "qheads"), fan_in=d),
    }


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _rwkv_wkv_scan(r, k, v, w, u, state0):
    """The recurrence, a loop over time steps in f32.  r, k, v, w:
    (B, S, H, hd) (w is the decay in (0, 1)); u: (H, hd); state0:
    (B, H, hd, hd), not written.  Returns (y (B, S, H, hd) f32, the final
    state)."""
    S = r.shape[1]
    rs, ks, vs, ws = (t.to(_F32) for t in (r, k, v, w))
    ub = u[None, :, :, None]
    state = state0
    ys = []
    for t in range(S):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]  # outer (B,H,i,j)
        ys.append(torch.matmul(rs[:, t, :, None, :],
                               state + ub * kv)[:, :, 0])
        state = state * ws[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), state


def _groupnorm_heads(y, scale, H: int, eps: float):
    """Per-head layer norm over hd (the population variance, as
    ``jnp.var``), then flattened and scaled by ``1 + scale``; f32 out."""
    B, S = y.shape[:2]
    yf = y.to(_F32)
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + eps)
    return yn.reshape(B, S, -1) * (1.0 + scale.to(_F32))


def rwkv6_time_mix(x, x_prev_shift, p, cfg: ModelConfig,
                   state0: Optional[torch.Tensor] = None):
    """x: (B, S, d); x_prev_shift: (B, 1, d), the hidden state before the
    segment (zeros at the start of a sequence).  Returns (out, the final
    WKV state (B, H, hd, hd) f32, the last x (B, 1, d))."""
    B, S, d = x.shape
    hd = cfg.ssm_head_dim
    H = d // hd
    xs = torch.cat([x_prev_shift, x[:, :-1]], dim=1)      # token shift
    xr = _lerp(x, xs, p["mu_r"])
    xk = _lerp(x, xs, p["mu_k"])
    xv = _lerp(x, xs, p["mu_v"])
    xw = _lerp(x, xs, p["mu_w"])
    xg = _lerp(x, xs, p["mu_g"])
    r = (xr @ p["w_r"]).reshape(B, S, H, hd)
    k = (xk @ p["w_k"]).reshape(B, S, H, hd)
    v = (xv @ p["w_v"]).reshape(B, S, H, hd)
    g = F.silu((xg @ p["w_g"]).to(_F32)).to(x.dtype)
    # the data-dependent decay (the "Finch" feature), in f32
    wlog = p["w0"].to(_F32) + (torch.tanh((xw @ p["wA"]).to(_F32))
                               @ p["wB"].to(_F32))
    w = torch.exp(-torch.exp(wlog)).reshape(B, S, H, hd)   # in (0, 1)
    if state0 is None:
        state0 = torch.zeros((B, H, hd, hd), dtype=_F32, device=x.device)
    y, state = _rwkv_wkv_scan(r, k, v, w, p["bonus_u"].to(_F32), state0)
    y = _groupnorm_heads(y, p["ln_x"], H, cfg.norm_eps)
    out = (y.to(x.dtype) * g) @ p["w_o"]
    return out, state, x[:, -1:]


def rwkv6_channel_mix(x, x_prev_shift, p, cfg: ModelConfig):
    """Returns (out (B, S, d), the last x (B, 1, d))."""
    xs = torch.cat([x_prev_shift, x[:, :-1]], dim=1)
    xk = _lerp(x, xs, p["mu_ck"])
    xr = _lerp(x, xs, p["mu_cr"])
    kk = torch.square(F.relu((xk @ p["w_ck"]).to(_F32))).to(x.dtype)
    gate = torch.sigmoid((xr @ p["w_cr"]).to(_F32)).to(x.dtype)
    return gate * (kk @ p["w_cv"]), x[:, -1:]
