"""The port's sharding layer (``repro_torch.sharding``) against the
reference's (``repro.sharding``), on stand-in meshes: ``rules_for`` and
``resolve_spec`` read only a mesh's axis names and shape, so the
production 16x16 and 2x16x16 meshes need no devices here.

- For every arch x applicable shape x mode (train, prefill, decode) on
  both meshes: the rule tables are equal, and for every parameter leaf
  (and every cache leaf of a decoder-only arch) the resolved spec is the
  reference's (``tuple(P)``) and so is the leaf's size a device holds.
- ``abstract_params`` leaf for leaf against the reference's
  ``jax.eval_shape`` tree, shape and dtype, and ``param_axes`` equal.
- ``placements`` on hand-picked specs.
- The twins of the reference's property tests of ``resolve_spec``
  (``tests/test_properties.py``): only dividing mesh axes, each used once;
  heads that do not divide the model axis replicate.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import encdec as jencdec
from repro.models import kvcache as jkvcache
from repro.models import transformer as jtransformer
from repro.sharding import logical as jlogical
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.models import encdec, kvcache, transformer
from repro_torch.sharding import logical

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("train", "prefill", "decode")


class _RefMesh:
    """The reference's stand-in (``tests/test_properties.py``)."""
    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = names


def meshes(name):
    shape, names = MESHES[name]
    return _RefMesh(shape, names), SimpleNamespace(mesh_dim_names=names,
                                                   shape=shape)


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts (jax arrays, tensors or axes
    tuples)."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


_ABSTRACT = {}


def abstract(arch):
    """(reference's eval_shape leaves, port's meta leaves, reference axes,
    port axes) of ``arch``, by path."""
    if arch not in _ABSTRACT:
        jcfg, cfg = jget_config(arch), get_config(arch)
        jm, m = (jencdec, encdec) if cfg.is_encoder_decoder else (
            jtransformer, transformer)
        _ABSTRACT[arch] = (flat(jm.abstract_params(jcfg)),
                           flat(m.abstract_params(cfg)),
                           flat(jm.param_axes(jcfg)), flat(m.param_axes(cfg)))
    return _ABSTRACT[arch]


def per_device_bytes(shape, itemsize, spec, sizes):
    n = int(np.prod(shape)) * itemsize
    for entry in spec:
        for ax in (entry if isinstance(entry, tuple) else
                   () if entry is None else (entry,)):
            n //= sizes[ax]
    return n


def test_every_arch_is_ported():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_rules_and_specs_match_the_reference(arch, mesh_name):
    jmesh, mesh = meshes(mesh_name)
    sizes = dict(zip(*MESHES[mesh_name][::-1]))
    jleaves, leaves, jaxes, axes = abstract(arch)
    assert jaxes.keys() == axes.keys() == jleaves.keys() == leaves.keys()
    jcfg, cfg = jget_config(arch), get_config(arch)
    caches = None
    if not cfg.is_encoder_decoder:
        caches = (flat(jkvcache.cache_axes(jcfg)),
                  flat(kvcache.cache_axes(cfg)),
                  flat(kvcache.init_cache(cfg, 128, 4096, device="meta")))
        assert caches[0] == caches[1]
    for shape in applicable_shapes(cfg):
        for mode in MODES:
            jrules = jlogical.rules_for(jcfg, jmesh, mode)
            rules = logical.rules_for(cfg, mesh, mode)
            assert rules == jrules, (shape, mode)
            for path, t in leaves.items():
                want = tuple(jlogical.resolve_spec(
                    jleaves[path].shape, jaxes[path], jmesh, jrules))
                got = logical.resolve_spec(t.shape, axes[path], mesh, rules)
                assert got == want, (shape, mode, path)
                assert per_device_bytes(t.shape, t.element_size(), got,
                                        sizes) == per_device_bytes(
                    jleaves[path].shape, jleaves[path].dtype.itemsize, want,
                    sizes)
            if caches is not None:
                for path, t in caches[2].items():
                    want = tuple(jlogical.resolve_spec(
                        t.shape, caches[0][path], jmesh, jrules))
                    assert logical.resolve_spec(
                        t.shape, caches[1][path], mesh, rules) == want


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_abstract_params_match_eval_shape(arch):
    jleaves, leaves, jaxes, axes = abstract(arch)
    assert jaxes == axes
    for path, t in leaves.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jleaves[path].shape), path
        assert str(t.dtype).split(".")[-1] == str(jleaves[path].dtype), path


def test_abstract_params_in_bfloat16():
    import dataclasses

    jcfg = dataclasses.replace(jget_config("jamba_v0_1_52b"),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("jamba_v0_1_52b"),
                              param_dtype="bfloat16")
    want = flat(jax.tree.map(lambda x: str(x.dtype),
                             jtransformer.abstract_params(jcfg)))
    got = {p: str(t.dtype).split(".")[-1]
           for p, t in flat(transformer.abstract_params(cfg)).items()}
    assert got == want
    assert got["/slots/slot0/mamba/A_log"] == "float32"


@pytest.mark.parametrize("spec, want", [
    ((), (Replicate(), Replicate(), Replicate())),
    ((None, "model"), (Replicate(), Replicate(), Shard(1))),
    ((("pod", "data"), None, "model"), (Shard(0), Shard(0), Shard(2))),
    (("data", "model"), (Replicate(), Shard(0), Shard(1))),
    ((None, ("data", "model")), (Replicate(), Shard(1), Shard(1))),
    (("pod",), (Shard(0), Replicate(), Replicate())),
])
def test_placements(spec, want):
    _, mesh = meshes("2x16x16")
    assert logical.placements(spec, mesh) == want


def test_placements_refuse_axes_out_of_mesh_order():
    _, mesh = meshes("2x16x16")
    with pytest.raises(ValueError, match="mesh order"):
        logical.placements((("model", "data"),), mesh)


def test_every_rule_names_its_axes_in_mesh_order():
    """So that ``placements`` never needs a strided shard."""
    order = ("pod", "data", "model")
    for table in (logical.TRAIN_RULES, logical.SERVE_RULES):
        for axes in table.values():
            idx = [order.index(a) for a in axes]
            assert idx == sorted(idx)


def _dims(seed, n=40):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b)) for a, b in rng.integers(1, 4097, (n, 2))] + [
        (256, 4096), (32, 16), (2, 48), (4096, 4096), (1, 1)]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("use_model", [False, True])
def test_resolve_spec_only_divisible(use_model, multi_pod):
    jmesh, mesh = meshes("2x16x16" if multi_pod else "16x16")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules = {"a": ("pod", "data"), "b": ("model",) if use_model else
             ("data",)}
    for dim0, dim1 in _dims(int(use_model) + 2 * int(multi_pod)):
        spec = logical.resolve_spec((dim0, dim1), ("a", "b"), mesh, rules)
        assert spec == tuple(jlogical.resolve_spec((dim0, dim1), ("a", "b"),
                                                   jmesh, rules))
        used = []
        for dim, entry in zip((dim0, dim1), spec + (None,) * 2):
            if entry is None:
                continue
            shard = 1
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                shard *= sizes[ax]
                used.append(ax)
            assert dim % shard == 0
        assert len(used) == len(set(used))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("heads", [24, 32, 48, 16, 12, 8])
def test_head_dim_fallback_consistency(heads, multi_pod):
    """Heads that 16 does not divide replicate (starcoder2's 24, qwen2's
    12), not crash or mis-shard."""
    _, mesh = meshes("2x16x16" if multi_pod else "16x16")
    spec = logical.resolve_spec((heads, 128), ("heads", None), mesh,
                                {"heads": ("model",)})
    assert spec == (("model",) if heads % 16 == 0 else ())


def test_rules_are_seen_from_another_thread():
    """The backward of a rematerialised block recomputes its forward on
    the autograd engine's device thread, under the rules of the forward."""
    import threading

    seen = []
    with logical.use_rules(logical.TRAIN_RULES, "mesh"):
        t = threading.Thread(target=lambda: seen.append(
            (logical.current_rules(), logical.current_mesh())))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [(logical.TRAIN_RULES, "mesh")]
    assert logical.current_rules() is None


def test_constraint_is_a_no_op_off_a_mesh():
    x = torch.randn(4, 8)
    assert logical.logical_constraint(x, "batch", "embed") is x
    with logical.use_rules(logical.TRAIN_RULES, None):
        assert logical.logical_constraint(x, "batch", "embed") is x
    assert logical.current_rules() is None and logical.current_mesh() is None
