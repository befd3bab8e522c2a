"""The port's plain Mamba scan (``repro_torch.models.ssm.chunked_scan``, the
``attn_impl="xla"`` path) against the reference's chunked scan
(``repro.models.ssm.mamba_forward``'s plain branch), at Falcon-Mamba's
smoke width (d_model 128, d_inner 256, state 8).

- ``associative_scan`` against ``jax.lax.associative_scan`` with the
  scan's combine, on random pairs: the same tree of pairs, 1e-6 relative
  (float32; the two frameworks may fuse a multiply and an add differently).
- ``mamba_forward`` in float32 compute from the reference's converted
  weights, for S in {1, 37, 256, 300} and ``ssm_chunk`` 32 and 256 (a
  padded tail where the chunk does not divide S), with and without a
  carried state: y within 1e-5 of its largest magnitude, the final ssm
  and conv states likewise.
- Gradients of a scalar of the block's output with respect to every
  parameter and the input, against ``jax.grad`` of the reference's, within
  1e-5 of each gradient's largest magnitude.
- Chunk remat (``torch.utils.checkpoint`` around each chunk body) on and
  off: values and gradients equal bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm
from test_torch_ssm import cfgs, draw, params

jforward = jax.jit(jssm.mamba_forward, static_argnums=(2, 3))


def rel_close(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * scale)


@pytest.mark.parametrize("n", [1, 2, 7, 37, 256])
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    # decays in [0.9, 1): a product of 256 stays a normal float32 (XLA on
    # the CPU flushes subnormals to zero, torch keeps them)
    a = rng.uniform(0.9, 1.0, (2, n, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 6, 4)).astype(np.float32)
    want = jax.lax.associative_scan(jssm._ssm_combine,
                                    (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = ssm.associative_scan(ssm._ssm_combine,
                               (torch.from_numpy(a), torch.from_numpy(b)),
                               axis=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("chunk", [32, 256])
@pytest.mark.parametrize("s", [1, 37, 256, 300])
def test_mamba_forward_matches_the_reference(s, chunk, carried):
    jcfg, tcfg = cfgs(ssm_chunk=chunk)
    jp, p = params("float32")
    jx, tx = draw(40 + s, (2, s, 128))
    jstate = state = None
    if carried:
        jconv, tconv = draw(41, (2, 3, 256))
        jh, th = draw(42, (2, 256, 8), scale=0.5)
        jstate, state = {"conv": jconv, "ssm": jh}, {"conv": tconv,
                                                     "ssm": th}
    want, jnew = jforward(jp, jx, jcfg, jnp.float32, jstate)
    got, new = ssm.mamba_forward(p, tx, tcfg, torch.float32, state=state)
    assert got.shape == (2, s, 128) and new["ssm"].dtype == torch.float32
    rel_close(got, want, 1e-5)
    rel_close(new["ssm"], jnew["ssm"], 1e-5)
    rel_close(new["conv"], jnew["conv"], 1e-5)


def test_gradients_match_jax_grad():
    """The gradient of a weighted sum of the block's output (every element
    weighted differently), 45 steps in chunks of 16."""
    jcfg, tcfg = cfgs(ssm_chunk=16)
    jp, p = params("float32")
    jx, tx = draw(50, (2, 45, 128))
    w = np.random.default_rng(51).standard_normal((2, 45, 128)).astype(
        np.float32)

    def jloss(jp, jx):
        y, _ = jssm.mamba_forward(jp, jx, jcfg, jnp.float32)
        return jnp.sum(y * jnp.asarray(w))

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    tx = tx.clone().requires_grad_(True)
    y, _ = ssm.mamba_forward(live, tx, tcfg, torch.float32)
    (y * torch.from_numpy(w)).sum().backward()
    rel_close(tx.grad, jg_x, 1e-5)
    for name, v in live.items():
        rel_close(v.grad, jg_p[name], 1e-5)


def test_chunk_remat_is_bitwise_neutral():
    gen = torch.Generator().manual_seed(3)
    b, s, d, n = 2, 70, 16, 4
    leaves = [torch.randn((b, s, d), generator=gen),
              torch.rand((b, s, d), generator=gen) * 0.1,
              torch.randn((b, s, n), generator=gen),
              torch.randn((b, s, n), generator=gen),
              -torch.rand((d, n), generator=gen) - 0.5,
              torch.randn((d,), generator=gen),
              torch.randn((b, d, n), generator=gen)]
    weight = torch.randn((b, s, d), generator=gen)
    out = {}
    for remat in (False, True):
        live = [t.clone().requires_grad_(True) for t in leaves]
        y, h = ssm.chunked_scan(*live[:6], 16, h0=live[6], remat=remat)
        ((y * weight).sum() + h.square().sum()).backward()
        out[remat] = [y.detach(), h.detach()] + [t.grad for t in live]
    for off, on in zip(out[False], out[True]):
        assert torch.equal(off, on)


def test_decode_step_is_one_chunk_of_one():
    """A carried state and S = 1: the scan is a chunk of one step, the
    recurrence h = exp(dt A) h0 + dt x B exactly."""
    _, tcfg = cfgs()
    gen = torch.Generator().manual_seed(4)
    x, dt = torch.randn((2, 1, 16), generator=gen), torch.rand((2, 1, 16),
                                                               generator=gen)
    bm, cm = torch.randn((2, 1, 4), generator=gen), torch.randn(
        (2, 1, 4), generator=gen)
    a, h0 = -torch.rand((16, 4), generator=gen), torch.randn(
        (2, 16, 4), generator=gen)
    y, h = ssm.chunked_scan(x, dt, bm, cm, a, torch.zeros(16),
                            tcfg.ssm_chunk, h0=h0)
    want = torch.exp(dt[:, 0, :, None] * a) * h0 \
        + (dt[:, 0] * x[:, 0])[..., None] * bm[:, 0, None, :]
    assert torch.equal(h, want)
    assert torch.equal(y[:, 0], torch.einsum("bdn,bn->bd", want, cm[:, 0]))
