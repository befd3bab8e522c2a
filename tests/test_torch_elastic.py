"""The port's ``launch/elastic.py`` (a renamed copy of the reference's,
pinned by ``test_torch_isolation.py``) against the reference's: the
scenarios of ``tests/test_launch.py`` run through each package's own
classes (the simulation, the CoE, the requests), with equal scaling
actions, completions and makespans."""
import pytest

import repro.core as jcore
import repro.core.workload as jworkload
import repro.launch.elastic as jelastic
import repro_torch.core as tcore
import repro_torch.core.workload as tworkload
import repro_torch.launch.elastic as telastic

# (executors, policy, requests, arrival interval, horizon s): scale up under
# a burst, drain while work remains, stay within bounds
SCENARIOS = {
    "scale up": (1, dict(max_executors=4, scale_up_pending_s=0.5), 500,
                 0.001, 30.0),
    "drain": (3, dict(min_executors=1, scale_down_pending_s=10.0,
                      scale_up_pending_s=1e9), 300, None, 5.0),
    "bounds": (2, dict(min_executors=2, max_executors=3,
                       scale_up_pending_s=0.1, scale_down_pending_s=0.0),
               400, 0.001, 20.0),
}


def run(core, workload, elastic, n_gpu, policy, n_req, interval, horizon):
    board = workload.BoardSpec(name="T", n_components=60, n_active=36,
                               n_detection=8)
    tier = core.TierSpec(name="t", unified=False, host_cache_bytes=2 << 30,
                         device_bytes=4 << 30)
    coe = workload.build_board_coe(board)
    pools, specs = workload.make_executor_specs(tier, n_gpu, 0)
    system = core.CoServeSystem(coe, specs, pools, policy=core.COSERVE,
                                tier=tier)
    ctl = elastic.ElasticController(system, specs[0],
                                    elastic.ElasticPolicy(**policy))
    sim = core.Simulation(system)
    kw = {} if interval is None else dict(interval=interval)
    sim.submit(workload.make_task_requests(board, n_req, **kw))
    ctl.install(sim, horizon_s=horizon)
    m = sim.run()
    return (m.completed, m.makespan, len(system.live_executors()),
            [dict(a) for a in ctl.actions])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_elastic_controller_acts_as_the_reference(name):
    args = SCENARIOS[name]
    got = run(tcore, tworkload, telastic, *args)
    want = run(jcore, jworkload, jelastic, *args)
    assert got == want
    assert got[0] == args[2]
    assert got[3], "the controller never acted"
