"""The port's layer primitives against ``repro.models.layers``, in float32.

Every ported function gets the same numpy-seeded inputs as its reference
twin; tolerance 1e-5 (float32 sums taken in another order), as for every
float32 comparison of the transformer slice.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as JL
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import layers as L

TOL = dict(rtol=1e-5, atol=1e-5)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def t(a):
    return torch.from_numpy(np.asarray(a))


def cfgs(arch, **changes):
    """The smoke config of ``arch`` in both packages, float32 compute."""
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jsmoke_config(jget_config(arch)), **changes),
            dataclasses.replace(smoke_config(get_config(arch)), **changes))


def test_norms():
    x, scale, bias = rand(0, 2, 5, 64), rand(1, 64), rand(2, 64)
    close(L.rmsnorm(t(x), t(scale)), JL.rmsnorm(x, scale))
    close(L.layernorm(t(x), t(scale), t(bias), 1e-6),
          JL.layernorm(x, scale, bias, 1e-6))
    for norm in ("rmsnorm", "layernorm"):
        p = {"scale": scale, "bias": bias}
        close(L.apply_norm(t(x), {k: t(v) for k, v in p.items()}, norm, 1e-5),
              JL.apply_norm(x, p, norm, 1e-5))


@pytest.mark.parametrize("sections", [(), (4, 6, 6)])
def test_rope(sections):
    np.testing.assert_array_equal(L.rope_frequencies(32, 1e5),
                                  JL.rope_frequencies(32, 1e5))
    x = rand(3, 2, 7, 4, 32)
    rng = np.random.default_rng(4)
    shape = (3, 2, 7) if sections else (2, 7)
    pos = rng.integers(0, 300, shape).astype(np.int32)
    close(L.apply_rope(t(x), t(pos), 1e5, sections),
          JL.apply_rope(x, pos, 1e5, sections))


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, 0, 0, None), (True, 7, 0, None), (False, 0, 0, None),
    (True, 0, 9, 20), (True, 5, 9, 17)])
def test_chunked_attention(causal, window, q_offset, kv_len):
    q, k, v = rand(5, 2, 11, 4, 32), rand(6, 2, 20, 2, 32), rand(7, 2, 20, 2, 32)
    kw = dict(causal=causal, window=window, chunk=8, q_offset=q_offset,
              kv_len=kv_len)
    close(L.chunked_attention(t(q), t(k), t(v), **kw),
          JL.chunked_attention(q, k, v, **kw))


@pytest.mark.parametrize("pos,window", [(3, 0), (15, 0), (40, 0), (40, 6)])
@pytest.mark.parametrize("with_new", [False, True])
def test_ring_decode_attention(pos, window, with_new):
    q = rand(8, 2, 1, 4, 32)
    kc, vc = rand(9, 2, 2, 16, 32), rand(10, 2, 2, 16, 32)
    new = (rand(11, 2, 2, 1, 32), rand(12, 2, 2, 1, 32)) if with_new else None
    got = L.ring_decode_attention(
        t(q), t(kc), t(vc), pos, window=window,
        new_kv=None if new is None else tuple(map(t, new)))
    close(got, JL.ring_decode_attention(q, kc, vc, pos, window=window,
                                        new_kv=new))


def _attn_params(cfg, seed):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {"wq": rand(seed, d, cfg.num_heads * hd) * 0.1,
            "wk": rand(seed + 1, d, cfg.num_kv_heads * hd) * 0.1,
            "wv": rand(seed + 2, d, cfg.num_kv_heads * hd) * 0.1,
            "wo": rand(seed + 3, cfg.num_heads * hd, d) * 0.1}


@pytest.mark.parametrize("arch", ["starcoder2_3b", "qwen2_vl_2b"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_block_three_modes(arch, impl):
    jcfg, tcfg = cfgs(arch, attn_impl=impl)
    p = _attn_params(tcfg, 20)
    tp = {k: t(v) for k, v in p.items()}
    x = rand(24, 2, 9, tcfg.d_model)
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    if tcfg.mrope_sections:
        pos = np.broadcast_to(pos[None], (3, 2, 9)).copy()
    f32 = jnp.float32
    # prefill
    got, (k, v) = L.attention_block(tp, t(x), tcfg, t(pos),
                                    compute_dtype=torch.float32)
    want, (jk, jv) = JL.attention_block(p, x, jcfg, pos, compute_dtype=f32)
    close(got, want)
    close(k, jk)
    close(v, jv)
    # decode against a wrapped ring: the port updates it in place
    kc, vc = rand(25, 2, 2, 8, 32), rand(26, 2, 2, 8, 32)
    x1 = rand(27, 2, 1, tcfg.d_model)
    pos1 = np.full(pos.shape[:-1] + (1,), 19, np.int32)
    tk, tv = t(kc.copy()), t(vc.copy())
    got, (nk, nv) = L.attention_block(tp, t(x1), tcfg, t(pos1),
                                      cache=(tk, tv), pos=19,
                                      compute_dtype=torch.float32)
    want, (jnk, jnv) = JL.attention_block(p, x1, jcfg, pos1, cache=(kc, vc),
                                          pos=19, compute_dtype=f32)
    close(got, want)
    close(nk, jnk)
    close(nv, jnv)
    assert nk is tk and nv is tv
    # cross-attention against precomputed KV
    ck, cv = rand(28, 2, 5, 2, 32), rand(29, 2, 5, 2, 32)
    got, _ = L.attention_block(tp, t(x), tcfg, None, cache=(t(ck), t(cv)),
                               cross_kv=(t(ck), t(cv)),
                               compute_dtype=torch.float32)
    want, _ = JL.attention_block(p, x, jcfg, None, cache=(ck, cv),
                                 cross_kv=(ck, cv), compute_dtype=f32)
    close(got, want)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp(mlp_type):
    x = rand(30, 2, 5, 64)
    if mlp_type == "swiglu":
        p = {"w_in": rand(31, 64, 2, 96) * 0.1, "w_down": rand(32, 96, 64) * 0.1}
    else:
        p = {"w_up": rand(31, 64, 96) * 0.1, "w_down": rand(32, 96, 64) * 0.1}
    close(L.mlp_block({k: t(v) for k, v in p.items()}, t(x), mlp_type,
                      torch.float32),
          JL.mlp_block(p, x, mlp_type, jnp.float32))


@pytest.mark.parametrize("logical_vocab", [0, 509])
def test_embed_and_unembed(logical_vocab):
    table = rand(33, 512, 64)
    tokens = np.random.default_rng(34).integers(0, 512, (2, 6))
    close(L.embed({"table": t(table)}, t(tokens), torch.float32),
          JL.embed({"table": table}, tokens, jnp.float32))
    x = rand(35, 2, 6, 64)
    got = L.unembed({"table": t(table)}, t(x), logical_vocab, torch.float32)
    want = JL.unembed({"table": table}, x, logical_vocab, jnp.float32)
    close(got, want)
    if logical_vocab:
        assert (got[..., logical_vocab:] < -1e29).all()


def test_init_draws_on_the_generator():
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, (256, 64), torch.float32)
    assert w.abs().max() <= 2.0 / 16 + 1e-7        # truncated at 2 std
    assert abs(w.std().item() * 16 - 0.88) < 0.05  # std of N(0,1) cut at 2
    again = L.dense_init(torch.Generator().manual_seed(0), (256, 64),
                         torch.float32)
    torch.testing.assert_close(w, again, rtol=0, atol=0)
    _, tcfg = cfgs("starcoder2_3b")
    p = L.init_attention(gen, tcfg, torch.bfloat16)
    assert p["wq"].dtype == torch.bfloat16 and p["wo"].shape == (128, 128)
