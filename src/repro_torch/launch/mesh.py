"""The verbs fabric's device grid.

`make_fabric_mesh(pods, devices_per_pod)` is the counterpart of the
reference's `repro.launch.mesh.make_fabric_mesh` over
``jax.devices()``: a ``(pods, devices_per_pod)`` grid of CUDA
`torch.device`s when the machine has exactly that many cards, else
``None`` — the logical-routing rig (one card, or the CPU), where fabric
addressing is identical and only the device hop differs. A function,
never a module-level constant, so importing this module touches no
device state. `make_mesh` and `make_production_mesh` come with the
parallelism slice (ROADMAP).
"""
from __future__ import annotations

import torch


def make_fabric_mesh(pods: int, devices_per_pod: int = 1):
    """A ``(pods, devices_per_pod)`` nested list of CUDA devices when
    ``torch.cuda.device_count()`` equals their product, else None."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if pods * devices_per_pod != n:
        return None
    return [[torch.device("cuda", p * devices_per_pod + d)
             for d in range(devices_per_pod)] for p in range(pods)]
