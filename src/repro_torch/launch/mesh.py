"""Meshes of torch devices (port of ``repro/launch/mesh.py``).

A :class:`Mesh` is the reference's ``jax.sharding.Mesh`` as the port's
single controller uses it: named axes, their sizes (``mesh.shape[axis]``,
as the reference reads them), and an array of ``torch.device`` of that
shape, one a mesh position.  Positions may share a device: eight positions
on one card (``["cuda:0"] * 8``), on the host in the tests (``["cpu"] *
8``), or on ``"meta"`` for the dry run, which allocates nothing.

``with mesh:`` makes it the current mesh (:func:`current_mesh`), as the
reference's ``with mesh:`` does: the sharding checks of ``act_spec`` and
``dispatch_spec`` read it.  Building a mesh touches no device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import resolve_device

_STACK: list = []


class Mesh:
    def __init__(self, devices, axis_names):
        devs = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(devs.shape):
            devs[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names) or devs.size == 0:
            raise ValueError(f"devices of shape {devs.shape} for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis names {axis_names}")
        self.devices = devs
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self):
        """Mesh coordinates in row-major order (the flattening order of a
        spec that names several axes)."""
        return list(np.ndindex(self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where the single controller computes."""
        return self.devices.flat[0]

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        return False

    def __repr__(self) -> str:
        shape = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        return f"Mesh({shape}; {sorted({str(d) for d in self.devices.flat})})"


def current_mesh() -> Mesh | None:
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _STACK[-1] if _STACK else None


def _cards(n: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"need {n} CUDA devices for {n} mesh positions, have {have} "
            "(pass devices=[...] to place the positions explicitly)"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh_auto(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  Without ``devices``, one CUDA card
    a position, the first of them; raises when there are fewer, rather than
    doubling positions up on a card or putting them on the host.
    ``devices`` places the positions explicitly, in row-major order,
    repeats allowed."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    devices = _cards(n) if devices is None else list(devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh needs {n} devices, got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16×16 single pod (256 positions) or 2×16×16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_auto(shape, axes, devices)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A small mesh over the devices that exist (the drivers and tests):
    the cards, or the one host or meta device that ``device`` names.  As in
    the reference, a mesh larger than the devices becomes ``(n, 1)``: on one
    card or on the CPU every shape trains at 1 × 1."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n, devices = 1, [dev]
    if data * model > n:
        data, model = n, 1
    return make_mesh_auto((data, model), ("data", "model"), devices[: data * model])
