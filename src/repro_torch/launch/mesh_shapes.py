"""Jax-free mesh shape/axis-role vocabulary.

The axis names and shape conventions used by :mod:`repro.launch.mesh`
(which builds real ``jax.Mesh`` objects) and :mod:`repro.sim.topology`
(which builds simulated device meshes) are the same vocabulary:

* single-pod: ``(16, 16)`` over ``("data", "model")`` — 256 chips,
* multi-pod:  ``(2, 16, 16)`` over ``("pod", "data", "model")`` — 512 chips.

Axis roles (DESIGN.md §4): ``("pod","data")`` = DP; ``"data"`` also carries
FSDP parameter sharding and long-context sequence parallelism; ``"model"``
= TP/EP.  This module must stay importable without jax — ``import repro``
and the whole simulator stack depend on it (see
``tests/test_topology.py::test_topology_import_is_jax_free``).
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = [
    "MESH_AXES",
    "production_shape",
    "tiny_shape",
    "axis_sizes",
    "dp_axis_names",
    "validate_shape",
]

#: Canonical axis-name tuples keyed by rank.  Rank-1 shapes (plain rings)
#: reuse the ``"data"`` role; rank-2/3 match the launch-layer meshes.
MESH_AXES: Dict[int, Tuple[str, ...]] = {
    1: ("data",),
    2: ("data", "model"),
    3: ("pod", "data", "model"),
}


def production_shape(*, multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return shape, MESH_AXES[len(shape)]


def tiny_shape(
    *, multi_pod: bool = False, data: int = 2, model: int = 2
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the CPU-test mesh with the same role structure."""
    shape = (2, data, model) if multi_pod else (data, model)
    return shape, MESH_AXES[len(shape)]


def axis_sizes(shape: Tuple[int, ...]) -> Dict[str, int]:
    """Axis-name → size map for ``shape`` (same as ``mesh_axis_sizes`` on a
    real mesh with the canonical axis names)."""
    validate_shape(shape)
    return dict(zip(MESH_AXES[len(shape)], shape))


def dp_axis_names(shape: Tuple[int, ...]) -> Tuple[str, ...]:
    """The data-parallel axes present on ``shape``, outermost first."""
    validate_shape(shape)
    return tuple(a for a in ("pod", "data") if a in MESH_AXES[len(shape)])


def validate_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Reject shapes outside the shared vocabulary (rank 1–3, positive dims)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in MESH_AXES:
        raise ValueError(
            f"mesh shape {shape!r} has rank {len(shape)}; supported ranks are "
            f"{sorted(MESH_AXES)} with axes {MESH_AXES}"
        )
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape!r} has non-positive dimensions")
    return shape
