"""Logical sharding rules and their placement on a mesh of torch devices
(port of ``repro/sharding.py``).

The rules are the reference's, against *logical axis names* ("data",
"model", and optionally "pod"); meshes of any physical shape map onto
them, which is what makes restarts elastic (checkpoints store
PartitionSpecs, not device layouts — see ``repro_torch.checkpoint``).

Parallelism summary (DESIGN.md §6):
  * DP  — batch over ("pod", "data")
  * TP  — attention heads / FFN columns / vocab over "model"
  * EP  — MoE experts over "model" when E % tp == 0, else TP inside experts
  * SP  — decode KV sequence over "data" when the batch can't fill it

**Placement.**  The reference partitions with GSPMD: ``jax.jit(step,
in_shardings=...)``.  Torch in one process has no partitioner, so the port
runs a single controller, as ``core/distributed.py``'s ``ShardMesh`` does:

  * :func:`place` puts a tensor on a mesh as a :class:`Placed` value, one
    block a distinct (device, block index).  Positions that share a device
    and a block share one tensor, so a 4 × 2 mesh of one card holds a
    model-sharded weight once, in two halves, not four times.
  * :class:`Jitted` (the port's ``jax.jit(fn, in_shardings=...,
    donate_argnums=...)``) gathers the placed arguments whole onto the
    mesh's first device, calls ``fn`` there inside ``with mesh:``, and
    places the outputs by their specs; a donated argument's blocks are
    written in place.  What GSPMD would partition — Megatron TP inside
    attention and the FFN, the data-parallel split of the batch — the port
    computes whole: results are held to the reference's contract, not to
    its layout of compute.  Per-position compute exists where the reference
    writes it explicitly, in ``models/moe_a2a.py``'s ``shard_map`` body.
  * :func:`constrain` is ``with_sharding_constraint``: the identity on
    values, after checking the spec against the current mesh (every axis
    in it, none twice, no more entries than dimensions).  Like GSPMD, it
    accepts a dimension its axes do not divide (GSPMD pads); placement, as
    ``jax.device_put``, refuses one.

**Collectives.**  The single controller's copies are counted by kind under
the reference's names (``launch/dryrun.py``): ``all-gather`` the bytes of
each sharded argument gathered whole, ``reduce-scatter`` the bytes written
into the blocks of a sharded output, ``all-reduce`` those of a replicated
output copied to another device, ``all-to-all`` the buffers that
``moe_ffn_a2a`` receives.  ``collective-permute`` has no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, current_mesh
from repro_torch.pytree import tree_leaves, tree_map

DATA_AXES = ("pod", "data")  # flattened for batch sharding when pod exists
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")


class P:
    """``jax.sharding.PartitionSpec``: one entry a tensor dimension, each
    None (replicated), an axis name or a tuple of axis names (the dimension
    split over their product, row-major).  As JAX does, a one-name tuple is
    the name and an empty tuple None; ``repr`` is JAX's, which checkpoints
    store."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = None if not p else (p[0] if len(p) == 1 else p)
            norm.append(p)
        self._parts = tuple(norm)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(("P", self._parts))

    def __repr__(self) -> str:
        inner = ", ".join(repr(p) for p in self._parts)
        return f"PartitionSpec({inner}{',' if len(self._parts) == 1 else ''})"


def data_axes(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def batch_spec(mesh) -> P:
    return P(data_axes(mesh))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _dense_layer_rules(cfg, tp: int, prefix_dims: int):
    """Specs for one dense/moe attention layer; prefix_dims=1 for stacked
    [L, ...] params, 0 for the unstacked shared block."""
    n = (None,) * prefix_dims
    rules = {
        "attn_norm": P(*n, None),
        "mlp_norm": P(*n, None),
        "wq": P(*n, None, "model"),
        "wk": P(*n, None, "model"),
        "wv": P(*n, None, "model"),
        "bq": P(*n, "model"),
        "bk": P(*n, "model"),
        "bv": P(*n, "model"),
        "wo": P(*n, "model", None),
        "w_gate": P(*n, None, "model"),
        "w_up": P(*n, None, "model"),
        "w_down": P(*n, "model", None),
    }
    if cfg.family == "moe":
        ep = (cfg.num_experts * cfg.moe_split) % tp == 0
        rules.update(
            {
                "router": P(*n, None, None),
                # EP when experts divide tp, else TP on the expert FFN dim
                "w_gate": P(*n, "model", None, None) if ep else P(*n, None, None, "model"),
                "w_up": P(*n, "model", None, None) if ep else P(*n, None, None, "model"),
                "w_down": P(*n, "model", None, None) if ep else P(*n, None, "model", None),
                "shared_gate": P(*n, None, "model"),
                "shared_up": P(*n, None, "model"),
                "shared_down": P(*n, "model", None),
            }
        )
    return rules


def _ssm_layer_rules(prefix_dims: int):
    n = (None,) * prefix_dims
    return {
        "norm": P(*n, None),
        "in_z": P(*n, None, "model"),
        "in_x": P(*n, None, "model"),
        "in_B": P(*n, None, None),
        "in_C": P(*n, None, None),
        "in_dt": P(*n, None, "model"),
        "conv_x": P(*n, None, "model"),
        "conv_B": P(*n, None, None),
        "conv_C": P(*n, None, None),
        "dt_bias": P(*n, "model"),
        "A_log": P(*n, "model"),
        "D_skip": P(*n, "model"),
        "norm_w": P(*n, "model"),
        "out_proj": P(*n, "model", None),
    }


def map_with_keys(fn, tree, keys: tuple = ()):
    """``jax.tree_util.tree_map_with_path`` over nested dicts and lists,
    with the path as the reference's rules read it: a dict key by name, a
    list index as None."""
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, v, keys + (None,)) for v in tree)
    if tree is None:
        return None
    return fn(list(keys), tree)


def param_specs(cfg, params, tp: int):
    """PartitionSpec pytree parallel to ``params``."""
    if cfg.family in ("ssm", "hybrid"):
        layer_rules = _ssm_layer_rules(prefix_dims=1)
    else:
        layer_rules = _dense_layer_rules(cfg, tp, prefix_dims=1)
    shared_rules = _dense_layer_rules(cfg, tp, prefix_dims=0)

    def spec_for(keys, leaf):
        if keys[0] == "embed":
            return P("model", None)
        if keys[0] == "lm_head":
            return P(None, "model")
        if keys[0] == "final_norm":
            return P(None)
        if keys[0] == "layers":
            return layer_rules[keys[1]]
        if keys[0] == "shared_attn":
            return shared_rules[keys[1]]
        raise KeyError(f"no sharding rule for param path {keys}")

    return map_with_keys(spec_for, params)


def cache_specs(cfg, cache, mesh, global_batch: int):
    """Per-layer KV / SSM-state specs for the decode cache.

    Batch shards over the data axes when it can fill them; otherwise the KV
    *sequence* dimension shards over "data" (SP decode, long_500k) while
    heads stay on "model".
    """
    daxes = data_axes(mesh)
    dsize = int(np.prod([mesh.shape[a] for a in daxes]))
    batch_fills = global_batch % dsize == 0 and global_batch >= dsize

    def spec_for(keys, leaf):
        name = keys[-1]
        if name == "pos":
            return P()
        if name in ("k", "v"):
            if batch_fills:
                return P(daxes, None, "model", None)
            return P(None, daxes, "model", None)
        if name == "ssm":  # [B, H, P, N]
            return P(daxes if batch_fills else None, "model", None, None)
        if name == "conv":  # [B, K-1, C]
            return P(daxes if batch_fills else None, None, "model")
        raise KeyError(f"no cache rule for {keys}")

    return map_with_keys(spec_for, cache)


def input_specs_sharding(mesh, inputs: dict):
    """Token/prefix inputs: batch over the data axes."""
    daxes = data_axes(mesh)

    def spec_for(name, leaf):
        if leaf.ndim >= 1:
            return P(daxes, *([None] * (leaf.ndim - 1)))
        return P()

    return {k: spec_for(k, v) for k, v in inputs.items()}


# ---------------------------------------------------------------------------
# collectives, counted
# ---------------------------------------------------------------------------

COLLECTIVES: dict = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def count_collective(kind: str, nbytes: int) -> None:
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    c = COLLECTIVES.setdefault(kind, {"count": 0, "bytes": 0})
    c["count"] += 1
    c["bytes"] += int(nbytes)


def collective_counts() -> dict:
    """The counts since the last reset, in the dry run's layout (the kinds
    that occurred, each ``{"count", "bytes"}``)."""
    return {k: dict(v) for k, v in COLLECTIVES.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# spec checks
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def check_spec(spec, ndim: int, mesh, what: str = "spec") -> None:
    """The checks JAX makes of a spec against a mesh and a rank: a
    ``PartitionSpec``, no more entries than dimensions, every axis in the
    mesh, no axis twice."""
    if not isinstance(spec, P):
        raise TypeError(f"{what} must be a PartitionSpec, got {spec!r}")
    if len(spec) > ndim:
        raise ValueError(f"{what} {spec!r} has {len(spec)} entries for a rank-{ndim} value")
    seen: list = []
    for entry in spec:
        for a in _entry_axes(entry):
            if a not in mesh.axis_names:
                raise ValueError(f"Resource axis: {a} of {spec!r} is not found in mesh: "
                                 f"{mesh.axis_names}.")
            if a in seen:
                raise ValueError(f"{what} {spec!r} uses axis {a!r} twice")
            seen.append(a)


def constrain(x, spec, what: str = "spec"):
    """``jax.lax.with_sharding_constraint(x, spec)``: checked against the
    current mesh (``with mesh:``), then ``x`` itself."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            f"{what} {spec!r} needs a mesh in context: call inside `with mesh:`, as "
            "with_sharding_constraint does"
        )
    check_spec(spec, x.ndim, mesh, what)
    return x


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _layout(shape, spec: P, mesh: Mesh, pos) -> tuple:
    """The block index of mesh position ``pos`` and each dimension's slice."""
    coords = dict(zip(mesh.axis_names, pos))
    entries = list(spec) + [None] * (len(shape) - len(spec))
    bidx, slices = [], []
    for d, (n, entry) in enumerate(zip(shape, entries)):
        count, idx = 1, 0
        for a in _entry_axes(entry):
            size = mesh.shape[a]
            count, idx = count * size, idx * size + coords[a]
        if n % count:
            raise ValueError(
                f"Sharding spec {spec!r} implies that array axis {d} is partitioned "
                f"{count} times, but does not evenly divide the dimension size {n}. "
                f"Got shape: {tuple(shape)}"
            )
        step = n // count
        bidx.append(idx)
        slices.append(slice(idx * step, (idx + 1) * step))
    return tuple(bidx), tuple(slices)


class Placed:
    """A tensor placed on a mesh: ``blocks[(device, block index)]`` is the
    block that every position on that device with that index holds."""

    def __init__(self, shape, dtype, spec: P, mesh: Mesh, blocks: dict, keys: dict,
                 slices: dict):
        self.shape, self.dtype, self.spec, self.mesh = tuple(shape), dtype, spec, mesh
        self.blocks = blocks
        self._keys = keys  # mesh position -> block key
        self._slices = slices  # block key -> its slice of the whole tensor

    def block_at(self, pos) -> torch.Tensor:
        return self.blocks[self._keys[pos]]

    def slices_of(self, key) -> tuple:
        return self._slices[key]

    @property
    def sharded(self) -> bool:
        return len({k[1] for k in self.blocks}) > 1

    def tensor(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first), not
        counted as a collective: the host's view, as ``np.asarray`` of a
        sharded ``jax.Array``."""
        return gather_tensor(self, device, count=False)

    def __float__(self) -> float:
        return float(self.tensor())

    def __int__(self) -> int:
        return int(self.tensor())

    def __repr__(self) -> str:
        return (f"Placed({list(self.shape)}, {self.dtype}, {self.spec!r}, "
                f"{len(self.blocks)} blocks)")


def place_tensor(t: torch.Tensor, spec: P, mesh: Mesh) -> Placed:
    """``jax.device_put(t, NamedSharding(mesh, spec))``.  A block that is
    the whole tensor on the tensor's own device is the tensor itself; every
    other block is a copy."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    check_spec(spec, t.ndim, mesh)
    src = _norm_device(t.device)
    blocks, keys, where = {}, {}, {}
    for pos in mesh.positions():
        dev = _norm_device(mesh.devices[pos])
        bidx, slices = _layout(t.shape, spec, mesh, pos)
        key = (dev, bidx)
        keys[pos] = key
        if key in blocks:
            continue
        where[key] = slices
        whole = all(s.start == 0 and s.stop == n for s, n in zip(slices, t.shape))
        if whole and dev == src:
            blocks[key] = t
        else:
            blocks[key] = t[slices].to(dev, copy=True, memory_format=torch.contiguous_format)
    return Placed(t.shape, t.dtype, spec, mesh, blocks, keys, where)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, ``specs`` a tree prefix of it whose
    ``P`` leaves cover whole subtrees (as ``in_shardings`` are)."""
    if isinstance(specs, P):
        return tree_map(lambda leaf: fn(leaf, specs), tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs, strict=True))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: map_specs(fn, getattr(tree, f.name),
                                                getattr(specs, f.name))
                             for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    raise ValueError(f"no PartitionSpec for the leaf {tree!r} (got {specs!r})")


def place(tree, specs, mesh: Mesh):
    """A pytree of tensors placed leaf by leaf; leaves already placed on
    ``mesh`` with the same spec stay as they are."""

    def one(leaf, spec):
        if isinstance(leaf, Placed):
            if leaf.mesh is mesh and leaf.spec == spec:
                return leaf
            leaf = gather(leaf)
        return place_tensor(leaf, spec, mesh)

    return map_specs(one, tree, specs)


def gather_tensor(p: Placed, device=None, *, count: bool = True) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the mesh's first device).
    A tensor held whole in one block there is that block; otherwise the
    blocks are copied into a new tensor, counted as an all-gather."""
    dev = _norm_device(device if device is not None else p.mesh.first_device)
    by_index: dict = {}
    for (bdev, bidx), blk in p.blocks.items():
        if bidx not in by_index or bdev == dev:
            by_index[bidx] = ((bdev, bidx), blk)
    if len(by_index) == 1:
        (key, blk), = by_index.values()
        if key[0] == dev:
            return blk
        return blk.to(dev)
    out = torch.empty(p.shape, dtype=p.dtype, device=dev)
    for key, blk in by_index.values():
        out[p.slices_of(key)].copy_(blk)
    if count:
        count_collective("all-gather", _nbytes(out))
    return out


def gather(tree, device=None):
    """Every placed leaf of ``tree`` whole on ``device`` (default: its
    mesh's first device); other leaves as they are."""
    return tree_map(lambda x: gather_tensor(x, device) if isinstance(x, Placed) else x,
                    tree)


def whole(tree, device=None):
    """Every placed leaf of ``tree`` as its whole tensor (``Placed.tensor``:
    the host's view of a result, not counted as a collective)."""
    return tree_map(lambda x: x.tensor(device) if isinstance(x, Placed) else x, tree)


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device == b.device and a.data_ptr() == b.data_ptr()
            and a.shape == b.shape and a.stride() == b.stride())


def write_into(p: Placed, value: torch.Tensor) -> Placed:
    """A donated argument's blocks written in place with ``value``'s."""
    if tuple(value.shape) != p.shape:
        raise ValueError(f"donated output of shape {tuple(value.shape)} for {p.shape}")
    with torch.no_grad():
        for key, blk in p.blocks.items():
            src = value[p.slices_of(key)]
            if not _same_view(src, blk):
                blk.copy_(src)
    _count_placement(p, value)
    return p


def _count_placement(p: Placed, value: torch.Tensor) -> None:
    """Count the copies that placed ``value`` (computed whole on the first
    device) into ``p``'s blocks: every block of a sharded output, and the
    blocks of a replicated one on other devices."""
    first = _norm_device(p.mesh.first_device)
    moved = sum(_nbytes(b) for (dev, _), b in p.blocks.items()
                if (p.sharded or dev != first) and not _same_view(b, value))
    if moved:
        count_collective("reduce-scatter" if p.sharded else "all-reduce", moved)


def place_output(value: torch.Tensor, spec: P, mesh: Mesh) -> Placed:
    """An output computed whole, placed by ``spec``; the copies counted."""
    p = place_tensor(value, spec, mesh)
    _count_placement(p, value)
    return p


def position_bytes(tree, pos) -> int:
    """Bytes one mesh position holds of a placed tree."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, Placed):
            total += _nbytes(leaf.block_at(pos))
    return total


def _signature(tree) -> list:
    return [(tuple(x.shape), x.dtype) for x in tree_leaves(tree)]


class Jitted:
    """``jax.jit(fn, in_shardings=in_specs, out_shardings=out_specs,
    donate_argnums=donate_argnums)`` for the single controller.

    A call places any argument that is not placed yet, gathers every
    argument whole onto the mesh's first device, calls ``fn`` there inside
    ``with mesh:`` and places its outputs by ``out_specs`` (a tree prefix
    of the outputs; default: replicated).  The output that matches a
    donated argument leaf for leaf, in shapes and dtypes (as XLA pairs
    donated buffers), is written into that argument's blocks, and the
    argument's placed tree is returned in its place.  ``last_memory`` holds
    the bytes a mesh position held of the last call's arguments, outputs
    and donated outputs (the largest over positions)."""

    def __init__(self, fn, mesh: Mesh, in_specs, out_specs=None, donate_argnums=()):
        self.fn, self.mesh = fn, mesh
        self.in_specs, self.out_specs = tuple(in_specs), out_specs
        self.donate_argnums = tuple(donate_argnums)
        self.last_memory: dict | None = None

    def __call__(self, *args):
        if len(args) != len(self.in_specs):
            raise TypeError(f"{len(args)} arguments for {len(self.in_specs)} specs")
        placed = tuple(place(a, s, self.mesh) for a, s in zip(args, self.in_specs))
        whole = [gather(a) for a in placed]
        with self.mesh:
            out = self.fn(*whole)
        del whole
        single = not isinstance(out, tuple)
        outs = (out,) if single else out
        specs = self.out_specs if self.out_specs is not None else P()
        if single or isinstance(specs, P):
            specs = (specs,) * len(outs)
        donated = {i: _signature(placed[i]) for i in self.donate_argnums}
        result, aliased = [], []
        for o, s in zip(outs, specs, strict=True):
            match = next((i for i, sig in donated.items() if sig == _signature(o)), None)
            if match is not None:
                del donated[match]
                result.append(tree_map(write_into, placed[match], o))
                aliased.append(result[-1])
            else:
                result.append(map_specs(lambda v, sp: place_output(v, sp, self.mesh), o, s))
        pos = self.mesh.positions()
        self.last_memory = {
            "argument_size_in_bytes": max(position_bytes(placed, q) for q in pos),
            "output_size_in_bytes": max(position_bytes(result, q) for q in pos),
            "alias_size_in_bytes": max(position_bytes(aliased, q) for q in pos),
        }
        return result[0] if single else tuple(result)
