"""Mamba-1 selective-state-space block (falcon-mamba, jamba's mamba layers):
the port of ``repro.models.ssm``.

A full sequence with no carried state (every prefill and full-sequence
forward) runs the scan through ``mamba_scan_op`` when ``cfg.attn_impl`` is
``"pallas"``, as the reference does: on the card that is the hand-written
kernel. Otherwise, and for decode (a carried (conv, ssm) state, one step:
a chunk of 1), the scan is the reference's chunked scan in its order of
operations (``chunked_scan``): a loop over ``cfg.ssm_chunk``-step chunks,
the sequence zero-dt padded to whole chunks, and inside each chunk the
``[B, chunk, d_inner, N]`` state expansion and an associative prefix scan
(``associative_scan``, the twin of ``jax.lax.associative_scan``'s tree), so
the ``[S, d_inner, N]`` tensor never materialises. Under autograd each
chunk body is rematerialised (``torch.utils.checkpoint``): the scan's tree
would otherwise keep every level of it for the backward, about nine chunk
tensors a chunk. ``kernels/ref.py``'s ``mamba_scan_ref``, the stepped
recurrence, stays the kernel's plain version.

Under rules and a mesh (``repro_torch.sharding``) the reference's hints
place the activations, and the scan runs on each rank's local shards
(``local_region``): it is independent for each (batch, channel).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import mamba_scan_op
from repro_torch.models.layers import apply_norm, cast_param, dense_init
from repro_torch.sharding.logical import (gather_leading, local_region,
                                          logical_constraint)


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
    p = {
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
    if cfg.ssm_dt_bc_norms:       # the mixer's RMSNorm scales (jamba)
        for name, n in (("dt_norm", rk), ("b_norm", st), ("c_norm", st)):
            p[name] = torch.ones((n,), dtype=dtype, device=dev)
    return p


MAMBA_AXES = {
    "in_proj": ("embed", "ssm_inner"),
    "conv_w": ("conv", "ssm_inner"),
    "conv_b": ("ssm_inner",),
    "x_proj": ("ssm_inner", None),
    "dt_proj": (None, "ssm_inner"),
    "dt_bias": ("ssm_inner",),
    "A_log": ("ssm_inner", "ssm_state"),
    "D": ("ssm_inner",),
    "out_proj": ("ssm_inner", "embed"),
}
# with ``cfg.ssm_dt_bc_norms``: the mixer's norm scales, replicated
MAMBA_NORM_AXES = {"dt_norm": (None,), "b_norm": (None,), "c_norm": (None,)}


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
    float32 with the dt bias. With ``cfg.ssm_dt_bc_norms`` the split's
    three parts each go through a weighted RMSNorm (``norm_eps``) before
    ``dt_proj`` and the scan, as Jamba's mixer normalises them (under
    ``"pallas"`` one launch of the norm kernel each). Under a mesh both
    products run on local shards: ``x_proj``'s sum over the sharded
    channels is partial until reduced, ``dt_proj``'s output is sharded as
    the channels are."""
    rk, st = cfg.dt_rank, cfg.ssm_state_dim
    inner, rows = ("batch", None, "ssm_inner"), ("batch", None, None)
    (proj,) = local_region(
        _product, (x_c, cast_param(params["x_proj"], compute_dtype)),
        (inner, MAMBA_AXES["x_proj"]), (rows,), partial=(("ssm_inner",),))
    proj = logical_constraint(proj, *rows)
    dt_r, b_c, c_c = torch.split(proj, [rk, st, st], dim=-1)
    if cfg.ssm_dt_bc_norms:
        dt_r, b_c, c_c = (
            apply_norm(v, {"scale": params[name]}, "rmsnorm", cfg.norm_eps,
                       cfg.attn_impl)
            for v, name in ((dt_r, "dt_norm"), (b_c, "b_norm"),
                            (c_c, "c_norm")))
    (dt_lin,) = local_region(
        _product, (dt_r, cast_param(params["dt_proj"], compute_dtype)),
        (rows, MAMBA_AXES["dt_proj"]), (inner,))
    dt = F.softplus(dt_lin.float() + params["dt_bias"].float())
    return dt, b_c.float(), c_c.float()


def _product(x, w):
    return (x @ w,)


def mamba_forward(params, x, cfg, compute_dtype=torch.bfloat16, state=None):
    """Full-sequence forward. x: [B,S,d] -> (y [B,S,d], final_state), the
    state {"conv": the last W-1 inputs of the conv, "ssm": h [B,di,st]
    float32}. With ``state`` the sequence continues from it (decode)."""
    x = gather_leading(x)
    xz = x @ cast_param(params["in_proj"], compute_dtype,
                        *MAMBA_AXES["in_proj"])
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in = logical_constraint(x_in, "batch", "seq_attn", "ssm_inner")
    conv_hist = None if state is None else state["conv"]
    seq = ("batch", None, "ssm_inner")
    # the conv runs along the sequence, for each channel: on local shards
    (x_c,) = local_region(
        lambda *a: (_causal_conv(*a),),
        (x_in, cast_param(params["conv_w"], compute_dtype),
         cast_param(params["conv_b"], compute_dtype), conv_hist),
        (seq, MAMBA_AXES["conv_w"], MAMBA_AXES["conv_b"], seq), (seq,))
    x_c = F.silu(x_c)

    dt, b_c, c_c = _ssm_inputs(params, x_c, cfg, compute_dtype)
    a = -torch.exp(params["A_log"].float())                   # [di, st]

    if cfg.attn_impl == "pallas" and x.shape[1] > 1 and state is None:
        y, h_final = mamba_scan_op(x_c, dt, b_c, c_c, a, params["D"])
    else:
        def scan(x_c, dt, b_c, c_c, a, d_vec, h0):
            return chunked_scan(x_c, dt, b_c, c_c, a, d_vec, cfg.ssm_chunk,
                                h0=h0)

        state_axes = ("batch", "ssm_inner", "ssm_state")
        y, h_final = local_region(
            scan, (x_c, dt, b_c, c_c, a, params["D"],
                   None if state is None else state["ssm"]),
            (seq, seq, ("batch", None, None), ("batch", None, None),
             MAMBA_AXES["A_log"], MAMBA_AXES["D"], state_axes),
            (seq, state_axes))
    # y is rounded to the compute dtype once on either path, as the
    # reference rounds its float32 scan output
    y = y.to(compute_dtype) * F.silu(z)
    out = y @ cast_param(params["out_proj"], compute_dtype,
                         *MAMBA_AXES["out_proj"])
    out = logical_constraint(out, "batch", "seq_q", "embed_act")
    new_state = {"conv": _conv_tail(x_in, cfg.ssm_conv_width, conv_hist),
                 "ssm": h_final}
    return out, new_state


def chunked_scan(x, dt, b_mat, c_mat, a, d_vec, chunk: int, h0=None,
                 remat=None):
    """The reference's chunked selective scan (its ``mamba_forward``'s
    plain branch), in its order of operations, float32.

    x, dt: [B,S,D]; b_mat, c_mat: [B,S,N] (float32); a: [D,N]; d_vec: [D];
    ``h0`` [B,D,N] the carried state (zeros without it). The sequence is cut
    into chunks of ``min(chunk, S)`` steps, the tail zero-padded (a padded
    step has dt 0: exp(0 A) = 1 and dt B x = 0, an identity). Each chunk
    expands ``exp(dt A)`` and ``dt x B`` to [B, chunk, D, N], scans them
    with ``_ssm_combine``, applies the carried state (``h_free + a_cum *
    h``), contracts with C and carries its last state. Returns (y [B,S,D]
    float32 with ``D * x`` added, h_final [B,D,N] float32).

    ``remat`` (default: grad enabled and an input requires grad)
    rematerialises each chunk body in the backward; the values and
    gradients are the same bit for bit."""
    bsz, s, d = x.shape
    n = b_mat.shape[-1]
    xf = x.float()
    chunk = min(chunk, s)
    n_chunks = (s + chunk - 1) // chunk
    pad = n_chunks * chunk - s
    xq, dtq, bq, cq = xf, dt, b_mat, c_mat
    if pad:
        xq, dtq, bq, cq = (F.pad(t, (0, 0, 0, pad)) for t in (xq, dtq, bq,
                                                              cq))
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    if remat is None:
        remat = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, b_mat, c_mat, a, h0))
    ys = []
    for i in range(n_chunks):
        part = [t[:, i * chunk:(i + 1) * chunk] for t in (xq, dtq, bq, cq)]
        if remat:
            h, y_ch = checkpoint(_chunk_body, h, *part, a,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            h, y_ch = _chunk_body(h, *part, a)
        ys.append(y_ch)
    y = torch.cat(ys, dim=1)[:, :s]
    return y + d_vec * xf, h


def _chunk_body(h, x_ch, dt_ch, b_ch, c_ch, a):
    """One chunk of ``chunked_scan``: (its last state, its y [B,chunk,D])."""
    da_c = torch.exp(dt_ch[..., None] * a)                 # [b, chunk, d, n]
    dbx_c = (dt_ch * x_ch)[..., None] * b_ch[..., None, :]
    a_cum, h_free = associative_scan(_ssm_combine, (da_c, dbx_c), axis=1)
    h_all = h_free + a_cum * h[:, None]                    # [b, chunk, d, n]
    y_ch = torch.einsum("bsdn,bsn->bsd", h_all, c_ch)
    return h_all[:, -1], y_ch


def _ssm_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _along(t, axis: int, start=None, stop=None, step=None):
    return t[(slice(None),) * axis + (slice(start, stop, step),)]


def associative_scan(fn, elems, axis: int = 0):
    """The twin of ``jax.lax.associative_scan(fn, elems, axis=axis)`` (not
    reversed) over a tuple of tensors, with its recursion: combine adjacent
    pairs, scan the half-length result, combine it with the even elements,
    and interleave. ``fn`` meets the same pairs in the same tree, so the
    result rounds as the reference's does."""
    def _scan(elems):
        num = elems[0].shape[axis]
        if num < 2:
            return elems
        reduced = fn([_along(e, axis, 0, -1, 2) for e in elems],
                     [_along(e, axis, 1, None, 2) for e in elems])
        odd = _scan(reduced)
        if num % 2 == 0:
            even = fn([_along(e, axis, 0, -1) for e in odd],
                      [_along(e, axis, 2, None, 2) for e in elems])
        else:
            even = fn(odd, [_along(e, axis, 2, None, 2) for e in elems])
        even = [torch.cat([_along(e, axis, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(ev, od, axis) for ev, od in zip(even, odd)]

    return tuple(_scan(list(elems)))


def _interleave(a, b, axis: int):
    """a[0], b[0], a[1], b[1], ... along ``axis``; ``a`` has as many
    elements as ``b`` or one more."""
    n = b.shape[axis]
    out = torch.stack([_along(a, axis, 0, n), b], dim=axis + 1).flatten(
        axis, axis + 1)
    if a.shape[axis] > n:
        out = torch.cat([out, _along(a, axis, n)], dim=axis)
    return out


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


MAMBA_STATE_AXES = {
    "conv": ("batch", None, "ssm_inner"),
    "ssm": ("batch", "ssm_inner", "ssm_state"),
}


def init_mamba_state(batch, cfg, dtype=torch.bfloat16, device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state_dim),
                           dtype=torch.float32, device=device),
    }
