"""Roofline terms and the least work of a step (port of the JAX package's
``roofline/``); see :mod:`repro_torch.roofline.analysis`."""
from repro_torch.roofline.analysis import (
    CollectiveStats,
    Roofline,
    Row,
    StepCost,
    collective_bytes,
    least_time,
    mfu,
    model_flops,
    roofline_share,
    step_cost,
)

__all__ = ["CollectiveStats", "Roofline", "Row", "StepCost",
           "collective_bytes", "least_time", "mfu", "model_flops",
           "roofline_share", "step_cost"]
