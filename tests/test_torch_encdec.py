"""The port's encoder-decoder model (``repro_torch.models.encdec``) against
``repro.models.encdec``, on Whisper-medium's smoke config (2 encoder and
2 decoder layers, d 128, 4 heads of 32, 16 audio frames, vocab 512 with
509 logical).

Weights are the reference's ``init_params`` converted with
``params_from_reference``; tokens and the stub frontend's frame embeddings
come from numpy seeds. The port runs ``attn_impl`` "xla" and "pallas" (on
the CPU the kernels' plain versions: non-causal flash for the encoder and
every cross-attention, causal flash for the decoder's prefill, decode
attention against the rings); the reference runs its XLA path, and in one
case its Pallas path (interpret mode). Tolerances: float32 1e-5, as in
``test_torch_models.py``; prefill + decode against the teacher-forced
logits 2e-4, as ``tests/test_arch_smoke.py`` holds the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import encdec as jencdec
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import flatten_params, nest_params, \
    params_from_reference
from repro_torch.models import encdec
from test_torch_models import close, tokens

ARCH = "whisper_medium"
jencode = jax.jit(jencdec.encode, static_argnums=(2,))
jdecode_train = jax.jit(jencdec.decode_train, static_argnums=(3,))
jprefill = jax.jit(jencdec.prefill, static_argnums=(3, 4))
jdecode = jax.jit(jencdec.decode_step, static_argnums=(4,))


def cfgs(**changes):
    changes.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jsmoke_config(jget_config(ARCH)), **changes),
            dataclasses.replace(smoke_config(get_config(ARCH)), **changes))


_REF = {}


def ref_params():
    if not _REF:
        jcfg, _ = cfgs()
        jp = jencdec.init_params(jax.random.PRNGKey(0), jcfg)
        _REF["p"] = jp, nest_params(params_from_reference(
            jax.tree.map(np.asarray, jp)))
    return _REF["p"]


def audio(seed, b, f=16, d=128):
    return np.random.RandomState(seed).standard_normal((b, f, d)).astype(
        np.float32)


_JAX_RUN = {}


def jax_run():
    """The reference's encode, cross K/V, teacher-forced logits, prefill
    and two decode steps (its XLA path), computed once."""
    if not _JAX_RUN:
        jcfg, _ = cfgs(attn_impl="xla")
        jp, _ = ref_params()
        toks, emb = tokens(1, 2, 12), audio(1, 2)
        jt, je = jnp.asarray(toks), jnp.asarray(emb)
        enc = jencode(jp, je, jcfg)
        out = {"encode": enc,
               "cross": jencdec.cross_kv(jp, enc, jcfg),
               "train": jdecode_train(jp, jt, je, jcfg)}
        logits, cache = jprefill(jp, jt, je, jcfg, 16)
        out["prefill"] = logits
        for pos in (12, 13):
            logits, cache = jdecode(jp, jt[:, pos - 12:pos - 11],
                                    jnp.int32(pos), cache, jcfg)
            out[f"step{pos}"] = logits
        out["cache"] = cache
        _JAX_RUN.update(toks=toks, emb=emb, want=out)
    return _JAX_RUN["toks"], _JAX_RUN["emb"], _JAX_RUN["want"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_entry_points_match_the_reference(impl):
    """encode, cross_kv, decode_train, prefill and two decode steps; the
    self-attention rings and the cross K/V after them."""
    _, tcfg = cfgs(attn_impl=impl)
    _, tp = ref_params()
    toks, emb, want = jax_run()
    tt, te = torch.from_numpy(toks), torch.from_numpy(emb)
    enc = encdec.encode(tp, te, tcfg)
    close(enc, want["encode"])
    xkv = encdec.cross_kv(tp, enc, tcfg)
    for n in ("k", "v"):
        assert xkv[n].shape == (2, 2, 16, 4, 32)
        close(xkv[n], want["cross"][n])
    got = encdec.decode_train(tp, tt, te, tcfg)
    assert got.shape == (2, 12, 512)
    close(got, want["train"])
    got, cache = encdec.prefill(tp, tt, te, tcfg, 16)
    close(got, want["prefill"])
    for pos in (12, 13):
        got, cache = encdec.decode_step(
            tp, tt[:, pos - 12:pos - 11], pos, cache, tcfg)
        close(got, want[f"step{pos}"])
    for part in ("self", "cross"):
        for n in ("k", "v"):
            close(cache[part][n], want["cache"][part][n])
    # the padded vocabulary's last 3 logits are masked
    assert (got[:, 509:] < -1e29).all()


def test_reference_pallas_path_agrees():
    """The reference's own Pallas path (flash attention non-causal and
    causal, decode attention, interpret mode) against the port's kernel
    path, through prefill and two decode steps."""
    jcfg, tcfg = cfgs(attn_impl="pallas")
    jp, tp = ref_params()
    toks, emb = tokens(2, 2, 10), audio(2, 2)
    want, jcache = jprefill(jp, jnp.asarray(toks), jnp.asarray(emb), jcfg,
                            12)
    got, cache = encdec.prefill(tp, torch.from_numpy(toks),
                                torch.from_numpy(emb), tcfg, 12)
    close(got, want)
    for pos in (10, 11):
        step = toks[:, pos - 10:pos - 9]
        want, jcache = jdecode(jp, jnp.asarray(step), jnp.int32(pos),
                               jcache, jcfg)
        got, cache = encdec.decode_step(tp, torch.from_numpy(step), pos,
                                        cache, tcfg)
        close(got, want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_teacher_forcing(impl):
    """Prefill, then decode steps fed their own greedy tokens: each step's
    logits equal the teacher-forced decoder's at that position (as
    ``tests/test_arch_smoke.py`` holds the reference)."""
    _, tcfg = cfgs(attn_impl=impl)
    _, tp = ref_params()
    toks, emb = torch.from_numpy(tokens(3, 2, 9)), torch.from_numpy(
        audio(3, 2))
    last, cache = encdec.prefill(tp, toks, emb, tcfg, 13)
    seq = toks
    for pos in range(9, 13):
        tok = torch.argmax(last, -1)[:, None].to(torch.int32)
        seq = torch.cat([seq, tok], dim=1)
        last, cache = encdec.decode_step(tp, tok, pos, cache, tcfg)
        full = encdec.decode_train(tp, seq, emb, tcfg)
        torch.testing.assert_close(last, full[:, -1], rtol=2e-4, atol=2e-4)


def test_port_init_matches_the_reference_layout():
    """The port's own init gives the reference's names, shapes and dtypes
    (bf16 params), and flatten/nest carry it to the store's flat dict and
    back."""
    jcfg, tcfg = cfgs(param_dtype="bfloat16")
    want = flatten_params(jax.tree.map(
        lambda a: (a.shape, str(a.dtype)),
        jax.eval_shape(lambda: jencdec.init_params(jax.random.PRNGKey(0),
                                                   jcfg))))
    params = encdec.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = flatten_params(params)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat.items()}
    assert got == want
    assert flatten_params(nest_params(flat)) == flat


@pytest.mark.parametrize("length,d,offset", [(16, 128, 0), (1, 128, 13),
                                             (1, 1024, 1553), (1500, 64, 0)])
def test_sinusoidal_positions_match_the_reference(length, d, offset):
    """1e-5, plus two float32 ulps of the largest angle (position x
    frequency): the two libraries' ``exp`` may differ by an ulp in a
    frequency, which moves an angle of 1553 radians by ~1e-4."""
    top = (offset + length - 1) * 1.0
    close(encdec.sinusoidal_positions(length, d, offset),
          jencdec.sinusoidal_positions(length, d, offset),
          dict(rtol=1e-5, atol=1e-5 + 2 * top * 2.0 ** -23))

