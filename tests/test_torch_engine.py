"""The port's real engine against the JAX package's, on the CPU.

``RingKVCache`` is fed the same appends as the JAX one (whose ``attend``
runs the Pallas kernel in interpret mode); ``RealEngine.execute`` runs the
reference's weights, converted, against the JAX apply; the host/disk store
round-trips; and asking for CUDA without a card raises instead of falling
back. Inputs come from numpy seeds. Tolerances: fp32 2e-5 and bf16 2e-2 for
attention (as in ``test_torch_decode_attention.py``), 1e-5 for the MLP
logits (float32 matmuls summed in another order).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.api import build as jbuild
from repro.core.engines import RingKVCache as JaxRing
from repro_torch.convert import params_from_reference
from repro_torch.core.coe import CoEModel, ExpertSpec, Request, RoutingModule
from repro_torch.core.engines import HostStore, RealEngine, RingKVCache

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_ring_kv_cache_matches_reference_through_wraparound(dtype, window):
    geo = dict(num_heads=4, num_kv_heads=2, head_dim=64, width=16,
               dtype=dtype, window=window)
    ours, theirs = RingKVCache(**geo, device="cpu"), JaxRing(**geo)
    rng = np.random.default_rng(window)
    t = 3 * geo["width"] + 5
    probe_at = {0, 1, 15, 16, 17, 32, t - 1}
    tol = ATTN_TOL[dtype]
    for p in range(t):
        k = rng.standard_normal((2, 64))
        v = rng.standard_normal((2, 64))
        assert ours.append(k, v) == theirs.append(k, v) == p
        if p in probe_at:
            q = rng.standard_normal((4, 64))
            got, want = ours.attend(q), theirs.attend(q)
            assert got.dtype == np.float32 and got.shape == (4, 64)
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)
    assert ours.k.dtype == getattr(torch, dtype) and ours.k.shape == (2, 16, 64)


def test_host_store_disk_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    params = {"w1": rng.standard_normal((8, 4)).astype(np.float32),
              "b1": np.zeros(4, np.float32)}
    store = HostStore(root=str(tmp_path))
    store.put_disk("e0", params)
    store.put_host("e1", params)
    assert (tmp_path / "e0.npz").exists() and "e0" not in store.host
    got, tier = store.fetch("e0")
    assert tier == "disk" and set(got) == set(params)
    for name, a in params.items():
        assert isinstance(got[name], torch.Tensor)
        np.testing.assert_array_equal(got[name].numpy(), a)
    assert store.fetch("e0")[1] == "host"       # the disk read cached it
    assert store.fetch("e1")[1] == "host"
    with pytest.raises(ValueError, match="root"):
        HostStore().put_disk("e2", params)


def test_host_store_disk_round_trips_bf16_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    params = {"attn.wq": w.to(torch.bfloat16),
              "norm.scale": torch.tensor([1.0, -0.0, float("inf"), 3e38]
                                         ).to(torch.bfloat16),
              "b": torch.zeros(4)}
    store = HostStore(root=str(tmp_path))
    store.put_disk("lm", params)
    got, tier = store.fetch("lm")
    assert tier == "disk" and set(got) == set(params)
    for name, t in params.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        if t.dtype == torch.bfloat16:
            assert torch.equal(got[name].view(torch.uint16),
                               t.view(torch.uint16))
        else:
            assert torch.equal(got[name], t)


def test_host_store_keeps_fp32_experts_as_before(tmp_path):
    """A float32 expert's file holds its arrays under their own names, as
    it did before bfloat16 experts were stored."""
    params = {"w1": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b1": np.ones(3, np.float32)}
    store = HostStore(root=str(tmp_path))
    store.put_disk("e0", params)
    with np.load(tmp_path / "e0.npz") as z:
        assert sorted(z.files) == ["b1", "w1"]
        for name, a in params.items():
            assert z[name].dtype == np.float32
            np.testing.assert_array_equal(z[name], a)


def _single_expert_engine(params):
    payload = {"make_batch": lambda reqs: np.stack([r.data["x"]
                                                    for r in reqs]),
               "interpret": lambda out: out}
    coe = CoEModel([ExpertSpec(id="e0", arch="tiny_cls", mem_bytes=1,
                               payload=payload)],
                   RoutingModule(lambda data: "e0"))
    store = HostStore()
    store.put_host("e0", params)
    from repro_torch.api.build import _tiny_apply_fns
    return RealEngine(coe, store, _tiny_apply_fns(), device="cpu")


@pytest.mark.parametrize("n", [1, 3, 8])
def test_execute_logits_match_jax_apply_on_converted_weights(n):
    ref_params = jbuild._tiny_params(jax.random.PRNGKey(4), 64, 32, 2)
    ref_np = {k: np.asarray(v) for k, v in ref_params.items()}
    engine = _single_expert_engine(params_from_reference(ref_np))
    engine.warm_place(None, "e0")
    rng = np.random.default_rng(n)
    reqs = [Request(id=i, expert_id="e0",
                    data={"x": rng.standard_normal(64).astype(np.float32)})
            for i in range(n)]
    logits, lat = engine.execute(None, "e0", reqs)
    x = np.stack([r.data["x"] for r in reqs])
    want = np.asarray(jbuild._tiny_apply_fns()["tiny_cls"](ref_params, x))
    assert logits.shape == (n, 2) and lat > 0
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)


def test_load_rides_the_transfer_worker():
    params = {"w1": torch.ones((64, 8)), "b1": torch.zeros(8),
              "w2": torch.ones((8, 2)), "b2": torch.zeros(2)}
    engine = _single_expert_engine(params)
    prof = types.SimpleNamespace(load_latency_host=0.25,
                                 load_latency_disk=1.0)
    ex = types.SimpleNamespace(device="gpu", profile=lambda arch: prof)
    assert engine.load(ex, "e0") == 0.25
    engine.wait_load(ex, "e0")
    assert set(engine.device_params["e0"]) == set(params)
    assert engine.measured_load_time > 0
    engine.unload(ex, "e0")
    assert "e0" not in engine.device_params


def test_dropped_engine_is_freed_after_a_load():
    """A transfer thread outlives its engine (it is a daemon waiting on its
    queue); once the engine is dropped, nothing of it may stay alive, or
    its device copies of the experts would leak from one system to the
    next."""
    import gc
    import weakref

    params = {"w1": torch.ones((64, 8)), "b1": torch.zeros(8),
              "w2": torch.ones((8, 2)), "b2": torch.zeros(2)}
    engine = _single_expert_engine(params)
    prof = types.SimpleNamespace(load_latency_host=0.25,
                                 load_latency_disk=1.0)
    ex = types.SimpleNamespace(device="gpu", profile=lambda arch: prof)
    engine.load(ex, "e0")
    engine.wait_load(ex, "e0")
    gone = weakref.ref(engine)
    worker = next(iter(engine._workers.values()))
    del engine
    worker._q.join()                 # the job's bookkeeping has finished
    gc.collect()
    assert gone() is None
    assert worker._thread.is_alive()


def test_params_from_reference_flattens_and_keeps_dtypes():
    bf16 = np.asarray(jax.numpy.asarray([1.5, -2.0], jax.numpy.bfloat16))
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "blk": {"k": bf16, "n": {"b": np.zeros(2, np.float32)}}}
    got = params_from_reference(tree)
    assert set(got) == {"w", "blk.k", "blk.n.b"}
    assert got["blk.k"].dtype == torch.bfloat16
    assert got["blk.k"].float().tolist() == [1.5, -2.0]
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])


def test_cuda_without_a_card_raises_and_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.api.build import build_real_system
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RingKVCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_real_system(n_components=2, n_detection=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--mode", "real", "--requests", "2", "--quiet"])
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        RingKVCache(device="meta")
