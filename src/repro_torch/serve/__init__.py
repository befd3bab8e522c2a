"""Online serving subsystem: streaming arrivals, multi-tenant SLO telemetry,
admission control and load-driven autoscaling over the CoServe core.

One source-of-truth per concern (stated in each module's docstring):
arrivals stamp tenant/deadline metadata, slo owns the targets, telemetry
owns the streaming counts, admission owns rejection, the autoscaler owns
runtime fleet changes, and the gateway is the single composition point.
"""
from repro_torch.serve.admission import AdmissionConfig, AdmissionController
from repro_torch.serve.arrivals import (BOARDS, TenantSpec, board_payload_stream,
                                  build_multi_board_coe, bursty_gaps,
                                  diurnal_gaps, make_gaps, merge_board_coe,
                                  merge_streams,
                                  multi_tenant_stream, poisson_gaps,
                                  step_gaps, tenant_stream)
from repro_torch.serve.autoscaler import Autoscaler, AutoscalerConfig, ScaleEvent
from repro_torch.serve.gateway import OnlineGateway, OnlineReport
from repro_torch.serve.slo import SLOPolicy, SLOTarget, deadline_priority
from repro_torch.serve.telemetry import (LatencyTracker, P2Quantile, TelemetryHub,
                                   WindowRate)

__all__ = [
    "AdmissionConfig", "AdmissionController", "BOARDS", "TenantSpec",
    "board_payload_stream", "build_multi_board_coe", "bursty_gaps",
    "diurnal_gaps", "make_gaps", "merge_board_coe", "merge_streams",
    "multi_tenant_stream",
    "poisson_gaps", "step_gaps", "tenant_stream", "Autoscaler",
    "AutoscalerConfig", "ScaleEvent", "OnlineGateway", "OnlineReport",
    "SLOPolicy", "SLOTarget", "deadline_priority", "LatencyTracker",
    "P2Quantile", "TelemetryHub", "WindowRate",
]
