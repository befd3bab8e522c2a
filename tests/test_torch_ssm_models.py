"""The port's LM stack for the SSM family against ``repro.models``:
Falcon-Mamba-7B's smoke config (pure Mamba-1, two layers). The checks are
shared with ``test_torch_hybrid_models.py``, which runs them on Jamba's
smoke config with its MoE switched off (one period of eight slots, an
attention slot at offset 4 among seven mamba slots).

Weights are the reference's ``init_params`` converted with
``params_from_reference``; tokens come from numpy seeds; the helpers are
those of ``test_torch_models.py``. Tolerances: float32 compute 1e-5 (sums
in another order). In bfloat16 the two frameworks round at different places
and the difference grows with depth (eight layers of Jamba: ~0.2 on logits
of magnitude ~3, about as far as either framework's bf16 logits lie from
its float32 ones), so there the port's bf16 logits are held against the
reference's float32 logits, no further from them than 1.5 times the
reference's own bf16 logits are.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import sampling as jsampling
from repro.models import transformer as jt
from repro_torch.models import kvcache, sampling, transformer
from test_torch_models import cfgs, close, jax_run, ref_params, tokens

# the reference's entry points, compiled once per config and shape (both
# decode steps share one program)
jforward = jax.jit(jt.forward, static_argnames=("cfg", "mode"))
jprefill = jax.jit(jt.prefill, static_argnums=(2, 3))
jdecode = jax.jit(jt.decode_step, static_argnums=(4,))


def check_forward_prefill_decode_logits(arch, impl):
    """The kernel path ("pallas"; on the CPU the kernels' plain versions)
    and the plain path against the reference's XLA path; every cache entry
    after two decode steps (the rings, and the mamba slots' conv and ssm
    states)."""
    _, tcfg = cfgs(arch, attn_impl=impl)
    _, tp = ref_params(arch)
    toks, want, jcache = jax_run(arch)
    got, aux = transformer.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want[0])
    assert float(aux) == 0.0
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 16)
    close(got, want[1])
    for i, pos in enumerate((12, 13)):
        got, cache = transformer.decode_step(
            tp, torch.from_numpy(toks[:, pos - 12:pos - 11]), pos, cache,
            tcfg)
        close(got, want[2 + i])
    assert sorted(cache) == sorted(jcache)
    for slot, entry in cache.items():
        assert sorted(entry) == sorted(jcache[slot])
        for name, value in entry.items():
            assert value.dtype == torch.float32
            close(value, jcache[slot][name])


def check_reference_pallas_path(arch):
    """The reference's own Pallas path (``mamba_scan`` in interpret mode,
    and jamba's flash and decode attention) against the port's kernel path,
    through forward, prefill and two decode steps."""
    jcfg, tcfg = cfgs(arch, attn_impl="pallas")
    jp, tp = ref_params(arch)
    toks = tokens(5, 2, 10)
    want, _ = jforward(jp, jnp.asarray(toks), cfg=jcfg, mode="eval")
    got, _ = transformer.forward(tp, torch.from_numpy(toks), tcfg)
    close(got, want)
    want, jcache = jprefill(jp, jnp.asarray(toks), jcfg, 12)
    got, cache = transformer.prefill(tp, torch.from_numpy(toks), tcfg, 12)
    close(got, want)
    for pos in (10, 11):
        step = toks[:, pos - 10:pos - 9]
        want, jcache = jdecode(jp, jnp.asarray(step), jnp.int32(pos),
                               jcache, jcfg)
        got, cache = transformer.decode_step(tp, torch.from_numpy(step), pos,
                                             cache, tcfg)
        close(got, want)


def check_bf16_compute(arch):
    """bf16 compute on the kernel path: forward, prefill and two decode
    steps, each no further from the reference's float32 logits than 1.5x
    the reference's bf16 logits; the conv state in the kv dtype, the ssm
    state in float32."""
    jcfg, tcfg = cfgs(arch, compute_dtype="bfloat16", attn_impl="pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, tp = ref_params(arch)
    toks, exact, _ = jax_run(arch)
    jx = jnp.asarray(toks)
    tx = torch.from_numpy(toks)
    ref = [jforward(jp, jx, cfg=jcfg, mode="eval")[0]]
    got = [transformer.forward(tp, tx, tcfg)[0]]
    out, jcache = jprefill(jp, jx, jcfg, 16)
    ref.append(out)
    out, cache = transformer.prefill(tp, tx, tcfg, 16)
    got.append(out)
    mamba = next(k for k, v in cache.items() if "ssm" in v)
    assert cache[mamba]["conv"].dtype == torch.bfloat16
    assert cache[mamba]["ssm"].dtype == torch.float32
    for pos in (12, 13):
        step = toks[:, pos - 12:pos - 11]
        out, jcache = jdecode(jp, jnp.asarray(step), jnp.int32(pos),
                              jcache, jcfg)
        ref.append(out)
        out, cache = transformer.decode_step(tp, torch.from_numpy(step), pos,
                                             cache, tcfg)
        got.append(out)
    for g, r, e in zip(got, ref, exact):
        assert g.dtype == torch.bfloat16
        e = np.asarray(e, np.float32)
        ref_err = np.abs(np.asarray(r, np.float32) - e).max()
        port_err = np.abs(g.float().numpy() - e).max()
        assert 0 < port_err <= 1.5 * ref_err, (port_err, ref_err)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_prefill_decode_logits(impl):
    check_forward_prefill_decode_logits("falcon_mamba_7b", impl)


def test_reference_pallas_path_agrees():
    check_reference_pallas_path("falcon_mamba_7b")


def test_bf16_compute():
    check_bf16_compute("falcon_mamba_7b")


def test_hybrid_period_caches_each_mixer_its_own_way():
    """Jamba's period: slot 4 is attention with a ring, the other seven
    are mamba with (conv, ssm) states; a falcon-mamba cache has only
    mamba slots."""
    _, tcfg = cfgs("jamba_v0_1_52b")
    assert [s.mixer for s in tcfg.block_pattern()] == \
        ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    cache = kvcache.init_cache(tcfg, 2, 16)
    for i, slot in enumerate(tcfg.block_pattern()):
        entry = cache[f"slot{i}"]
        if slot.mixer == "attn":
            assert entry["k"].shape == (1, 2, 2, 16, 32)
        else:
            assert entry["conv"].shape == (1, 2, 3, 256)
            assert entry["ssm"].shape == (1, 2, 256, 8)
    _, fcfg = cfgs("falcon_mamba_7b")
    cache = kvcache.init_cache(fcfg, 1, 16)
    assert list(cache) == ["slot0"]
    assert cache["slot0"]["ssm"].shape == (2, 1, 256, 8)


def check_greedy_generate(arch):
    """Greedy generation on the kernel path (prefill through the scan
    kernel's plain version, then the decode recurrence) equals teacher
    forcing through the full-sequence forward, and the reference's
    ``generate``."""
    jcfg, tcfg = cfgs(arch, attn_impl="pallas")
    jcfg = dataclasses.replace(jcfg, attn_impl="xla")
    jp, tp = ref_params(arch)
    prompt = tokens(0, 2, 8)
    out = sampling.generate(tp, torch.from_numpy(prompt), tcfg,
                            max_new_tokens=5)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    seq = torch.from_numpy(prompt)
    for i in range(5):
        logits, _ = transformer.forward(tp, seq, tcfg)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        torch.testing.assert_close(out[:, i], nxt, rtol=0, atol=0)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    want = jsampling.generate(jp, jnp.asarray(prompt), jcfg,
                              max_new_tokens=5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_greedy_generate_matches_teacher_forcing_and_the_reference():
    check_greedy_generate("falcon_mamba_7b")
