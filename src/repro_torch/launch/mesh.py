"""The dry run's meshes (the port's counterpart of ``repro.launch.mesh``).

A :class:`Mesh` names its axes and sizes as the reference's JAX mesh
does (``shape``, ``axis_names``, ``devices.shape``).  The port places by
(data, model) only: the pod axis is folded into data (:meth:`Mesh.
placement`), as the reference's batch and ZeRO-3 rules treat (pod,
data) together; an artifact records all three axes.  Building a mesh
touches no process group: the dry run runs one rank of it under
``distributed.dry.fake_world``.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.distributed.sharding import ServingMesh


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: tuple                     # ((name, size), ...), outermost first

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(n for n, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)

    @property
    def tag(self) -> str:
        """``16x16`` or ``2x16x16``, the artifact name's part."""
        return "x".join(str(n) for _, n in self.axes)

    def placement(self) -> ServingMesh:
        """(data, model) with the pod axis folded into data."""
        shape = self.shape
        return ServingMesh(shape.get("pod", 1) * shape["data"], shape["model"])


def _mesh(shape: tuple, multi_pod: bool) -> Mesh:
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(tuple(zip(names, shape)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 256 chips as (data=16, model=16).
    Multi-pod: 2 pods x 256 chips as (pod=2, data=16, model=16)."""
    return _mesh((2, 16, 16) if multi_pod else (16, 16), multi_pod)


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """Scaled-down mesh for the tests: (2, 4), or (2, 2, 2)."""
    return _mesh((2, 2, 2) if multi_pod else (2, 4), multi_pod)
