"""Fault tolerance: straggler detection and elastic rescale planning."""
from repro_torch.ft.elastic import RescalePlan, plan_rescale, plan_serve_rescale, resume
from repro_torch.ft.straggler import FleetMonitor, StepTimer, StragglerConfig

__all__ = ["RescalePlan", "plan_rescale", "plan_serve_rescale", "resume", "FleetMonitor",
           "StepTimer", "StragglerConfig"]
