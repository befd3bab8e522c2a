"""The wall-clock recorder against the card's own trace (marked ``cuda``;
skips without a card): a program span and the kernels it launched share one
clock with ``torch.profiler``, and a ``forward`` span's CUDA-event device
time is its kernels' time. No JAX here: the card's machine has none.

    python -m pytest -q -m cuda tests/test_torch_obs_wall_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.simulator import run_real
from repro_torch.launch import lm_coe_router as lm
from repro_torch.models import transformer
from repro_torch.obs import Tracer
from repro_torch.obs import tracer as obs_tracer

SLACK_NS = 50_000          # a span holds its kernel to within 50 us a side


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernels(prof):
    """(name, start ns, end ns) of the device's kernels in a finished
    profiler, on its time base."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.name().startswith(("Memcpy", "Memset")):
            continue
        out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda k: k[1])


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_a_span_around_a_kernel_holds_its_interval_in_the_trace(cuda):
    a = torch.randn((4096, 4096), device=cuda)
    b = torch.randn((4096, 4096), device=cuda)
    a @ b                                      # warm: cuBLAS's handle
    torch.cuda.synchronize()
    tracer = Tracer("full", wall=True)
    with _profile() as prof:
        for _ in range(5):
            with tracer.span("host", "test", "matmul"):
                a @ b
                torch.cuda.synchronize()
    spans = list(tracer.events)
    kernels = _kernels(prof)
    assert len(spans) == 5 and kernels
    held = {id(s): [] for s in spans}
    for _, k0, k1 in kernels:
        (span,) = [s for s in spans if s.wall_ns - SLACK_NS <= k0
                   and k1 <= s.wall_end_ns + SLACK_NS]
        held[id(span)].append(k1)
    for span in spans:
        # the sync returns soon after the span's last kernel ends: the
        # clocks agree closely, not merely within a long span
        assert held[id(span)]
        assert span.wall_end_ns - max(held[id(span)]) < 1_000_000


@pytest.mark.cuda
def test_forward_device_time_is_its_kernels_time(cuda):
    """StarCoder2-3B at its width, two layers, 4 x 512 tokens in bf16.
    Float32 products queued first (some 40 ms of them) let the host enqueue
    the whole forward before it starts, so the forward's kernels run back
    to back and its CUDA-event time is their union's, launches aside."""
    cfg = lm.lm_config("full", 2, "starcoder2_3b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = transformer.init_params(gen, cfg)
    x = torch.randint(0, cfg.vocab_size, (4, 512), dtype=torch.int32,
                      device=cuda)
    with torch.no_grad():
        transformer.forward(params, x, cfg)    # warm: builds the kernels
    torch.cuda.synchronize()
    tracer = Tracer("full", wall=True)
    a = torch.randn((4096, 4096), device=cuda)
    a @ a
    torch.cuda.synchronize()
    with _profile() as prof, torch.no_grad():
        for _ in range(20):
            a @ a
        with obs_tracer.activated(tracer):
            transformer.forward(params, x, cfg)
        torch.cuda.synchronize()
    tracer.read_device_times()
    (fwd,) = tracer.events
    kernels = _kernels(prof)
    first = kernels[0][0]                       # the float32 product's
    queued = [k for k in kernels if k[0] == first]
    # the profiler may miss the first of them as it starts
    assert len(queued) >= 15 and queued[-1][2] - queued[0][1] > 5_000_000
    union, end = 0, queued[-1][2]
    for _, k0, k1 in kernels[kernels.index(queued[-1]) + 1:]:
        k0 = max(k0, end)
        if k1 > k0:
            union += k1 - k0
            end = k1
    device_ns = fwd.attrs["device_us"] * 1e3
    assert union > 0
    assert abs(device_ns - union) <= 0.10 * union, (device_ns, union)


@pytest.mark.cuda
def test_a_real_engine_run_on_the_card_times_every_forward(cuda):
    tracer = Tracer("full", wall=True)
    cfg = lm.lm_config("smoke", 0, "starcoder2_3b")
    system, _ = lm.build_lm_system(cfg, device=cuda, tracer=tracer)
    m = run_real(system, lm.make_requests(np.random.RandomState(0), cfg, 20))
    assert m.completed == 20
    dicts = tracer.to_dicts()
    forwards = [d for d in dicts if d["name"] == "forward"]
    assert len(forwards) == sum(d["kind"] == "exec" for d in dicts) > 0
    assert all(d["attrs"]["device_us"] > 0 for d in forwards)
    assert tracer.dropped == 0
