"""Mamba-1 selective-state-space block (falcon-mamba, jamba's mamba layers):
the port of ``repro.models.ssm``.

A full sequence with no carried state (every prefill and full-sequence
forward) runs the scan through ``mamba_scan_op`` when ``cfg.attn_impl`` is
``"pallas"``, as the reference does: on the card that is the hand-written
kernel. Otherwise, and for decode (a carried (conv, ssm) state), the scan is
the kernel's plain version, ``mamba_scan_ref``: the float32 recurrence
stepped in order from the carried state (where the reference runs a chunked
associative scan; both are exact in float32 up to rounding). The reference's
sharding constraints (``logical_constraint``, ``MAMBA_AXES``) have nothing
to do on one card and are left out.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import mamba_scan_op
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models.layers import cast_param, dense_init


def init_mamba(gen: torch.Generator, cfg, dtype):
    """One mamba layer's parameters on ``gen``'s device. ``A_log`` (S4D-real)
    and the dt bias (softplus(dt) log-uniform in [1e-3, 1e-1], drawn from
    ``np.random.RandomState(0)``) are the reference's, bit for bit; the
    dense weights come from ``gen``."""
    d, di = cfg.d_model, cfg.d_inner
    st, rk, w = cfg.ssm_state_dim, cfg.dt_rank, cfg.ssm_conv_width
    dev = gen.device
    a = np.tile(np.arange(1, st + 1, dtype=np.float32), (di, 1))
    dt = np.exp(np.random.RandomState(0).uniform(math.log(1e-3),
                                                 math.log(1e-1), di)
                ).astype(np.float32)
    dt_bias = dt + np.log(-np.expm1(-dt))  # inverse softplus
    return {
        "in_proj": dense_init(gen, (d, 2 * di), dtype),
        "conv_w": dense_init(gen, (w, di), dtype, fan_in=w),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, (di, rk + 2 * st), dtype, fan_in=di),
        "dt_proj": dense_init(gen, (rk, di), dtype, fan_in=rk),
        "dt_bias": torch.from_numpy(dt_bias).to(dev, dtype),
        "A_log": torch.from_numpy(np.log(a)).to(dev),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, d), dtype, fan_in=di),
    }


def _causal_conv(x, conv_w, conv_b, history=None):
    """Depthwise causal conv. x: [B,S,di], conv_w: [W,di].
    ``history``: [B,W-1,di] previous inputs (decode) or None (zero-pad).
    The reference's sum of shifted products over the W taps, in its order:
    in bf16 that order is part of the result."""
    w = conv_w.shape[0]
    if history is None:
        xp = F.pad(x, (0, 0, w - 1, 0))
    else:
        xp = torch.cat([history.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * conv_w[i] for i in range(w))
    return out + conv_b


def _ssm_inputs(params, x_c, cfg, compute_dtype):
    """Project to (dt [.., di], B [.., st], C [.., st]), all float32:
    ``x_proj`` and ``dt_proj`` in the compute dtype, the softplus in
    float32 with the dt bias."""
    rk, st = cfg.dt_rank, cfg.ssm_state_dim
    proj = x_c @ cast_param(params["x_proj"], compute_dtype)
    dt_r, b_c, c_c = torch.split(proj, [rk, st, st], dim=-1)
    dt = F.softplus((dt_r @ cast_param(params["dt_proj"], compute_dtype)
                     ).float() + params["dt_bias"].float())
    return dt, b_c.float(), c_c.float()


def mamba_forward(params, x, cfg, compute_dtype=torch.bfloat16, state=None):
    """Full-sequence forward. x: [B,S,d] -> (y [B,S,d], final_state), the
    state {"conv": the last W-1 inputs of the conv, "ssm": h [B,di,st]
    float32}. With ``state`` the sequence continues from it (decode)."""
    s = x.shape[1]
    xz = x @ cast_param(params["in_proj"], compute_dtype)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    conv_hist = None if state is None else state["conv"]
    x_c = F.silu(_causal_conv(x_in, cast_param(params["conv_w"],
                                               compute_dtype),
                              cast_param(params["conv_b"], compute_dtype),
                              conv_hist))

    dt, b_c, c_c = _ssm_inputs(params, x_c, cfg, compute_dtype)
    a = -torch.exp(params["A_log"].float())                   # [di, st]

    if cfg.attn_impl == "pallas" and s > 1 and state is None:
        y, h_final = mamba_scan_op(x_c, dt, b_c, c_c, a, params["D"])
    else:
        y, h_final = mamba_scan_ref(x_c, dt, b_c, c_c, a, params["D"],
                                    h0=None if state is None
                                    else state["ssm"])
    # y is rounded to the compute dtype once on either path, as the
    # reference rounds its float32 scan output
    y = y.to(compute_dtype) * F.silu(z)
    out = y @ cast_param(params["out_proj"], compute_dtype)
    new_state = {"conv": _conv_tail(x_in, cfg.ssm_conv_width, conv_hist),
                 "ssm": h_final}
    return out, new_state


def _conv_tail(x_in, width, history):
    """Last W-1 inputs, for decode continuation."""
    need = width - 1
    if history is not None:
        x_in = torch.cat([history.to(x_in.dtype), x_in], dim=1)
    s = x_in.shape[1]
    if s >= need:
        return x_in[:, s - need:s]
    return F.pad(x_in, (0, 0, need - s, 0))


def mamba_decode_step(params, x, state, cfg, compute_dtype=torch.bfloat16):
    """Single-token recurrence. x: [B,1,d]; state {conv [B,W-1,di],
    ssm [B,di,st]}."""
    return mamba_forward(params, x, cfg, compute_dtype, state=state)


def init_mamba_state(batch, cfg, dtype=torch.bfloat16, device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state_dim),
                           dtype=torch.float32, device=device),
    }
