"""FliX data-layer state (port of ``repro/core/state.py``).

Bucket ``b`` owns node slots ``keys[b, 0..num_nodes[b])`` — slot order is
chain order, every array is a torch tensor, and every plane is int32.

Invariants (``core/invariants.py`` checks them):
  I1. within a node, ``keys[b, j, :count]`` is strictly ascending; the rest of
      the row is ``EMPTY``.
  I2. slots are chain-ordered: every key in node ``j`` < every key in ``j+1``.
  I3. every key in bucket ``b`` is ≤ ``mkba[b]`` and > ``mkba[b-1]``.
  I4. ``node_max[b, j]`` equals the largest key of node ``j`` (``EMPTY`` when
      the slot is inactive), so each ``node_max[b]`` row is ascending.
  I5. ``mkba`` is strictly ascending with ``mkba[-1] == MAX_VALID``.

I6 (expiry liveness) lives in ``core/expiry.py`` and is checked with the
others when the state carries an expiry plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

KEY_DTYPE = torch.int32
VAL_DTYPE = torch.int32

EMPTY = 2**31 - 1  # empty slot / inactive-node sentinel (int32 max)
MAX_VALID = EMPTY - 1  # largest storable key
MIN_KEY = -(2**31)  # conceptual lower fence
NOT_FOUND = -1  # point-query miss sentinel

# the carry-over fields every state has: what ``state_to_numpy`` /
# ``state_from_numpy`` always move
STATE_FIELDS = (
    "keys",
    "vals",
    "node_count",
    "node_max",
    "num_nodes",
    "mkba",
    "needs_restructure",
)
# the optional fields, moved when a state (or the host dict) carries them
OPTIONAL_FIELDS = ("succ_smin", "succ_sidx", "exps")

# elements per bucket chunk in the batched plain-torch passes: bounds their
# temporaries (int64 sort indices included) at a few hundred MB whatever nb is
CHUNK_ELEMS = 1 << 24


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  ``None`` means CUDA and raises when there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def bucket_chunks(nb: int, per_bucket: int) -> list[tuple[int, int]]:
    """``[c0, c1)`` bucket ranges of at most ``CHUNK_ELEMS`` elements each."""
    step = max(1, CHUNK_ELEMS // max(per_bucket, 1))
    return [(c0, min(c0 + step, nb)) for c0 in range(0, nb, step)]


@dataclasses.dataclass(frozen=True)
class FliXState:
    """FliX instance: a frozen bundle of int32 tensors on one device.
    Operations return new states and write their input only where the
    caller donates it (``ExecConfig.donate``; ``apply_ops_safe`` does by
    default): a donated state's ``keys``, ``vals``, ``node_count`` and
    ``node_max`` become the result's, and the caller must not read them as
    the old state afterwards."""

    keys: torch.Tensor  # [nb, npb, ns] EMPTY-padded
    vals: torch.Tensor  # [nb, npb, ns]
    node_count: torch.Tensor  # [nb, npb] keys stored per node slot
    node_max: torch.Tensor  # [nb, npb] EMPTY when inactive
    num_nodes: torch.Tensor  # [nb] active slots per bucket
    mkba: torch.Tensor  # [nb] max allowable key per bucket
    needs_restructure: torch.Tensor  # [] bool, bucket overflow pressure flag

    # Optional successor-fallback cache (``core.query.with_successor_cache``):
    # the padded suffix-min rows over per-bucket minimum present keys, [nb+1]
    # each.  Every mutating operation constructs its result without them, so
    # the cache is invalidated by construction; only read-only query streams
    # carry it forward.
    succ_smin: torch.Tensor | None = None
    succ_sidx: torch.Tensor | None = None

    # Optional per-key expiry plane (``core.expiry``): absolute deadlines in
    # the virtual time of the ``now`` threaded through ``apply_ops``,
    # ``NO_EXPIRY`` (== EMPTY) at empty slots and for keys without a TTL.
    # Durable logical state: ``drop_volatile`` keeps it.
    exps: torch.Tensor | None = None  # [nb, npb, ns] int32 or None

    def drop_volatile(self) -> "FliXState":
        """This state without its volatile successor-cache fields."""
        if self.succ_smin is None and self.succ_sidx is None:
            return self
        return dataclasses.replace(self, succ_smin=None, succ_sidx=None)

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def geometry(self) -> tuple[int, int, int]:
        """(num_buckets, nodes_per_bucket, node_size)."""
        return tuple(self.keys.shape)

    @property
    def nodes_per_bucket(self) -> int:
        return self.keys.shape[1]

    @property
    def node_size(self) -> int:
        return self.keys.shape[2]

    @property
    def bucket_capacity(self) -> int:
        return self.nodes_per_bucket * self.node_size

    def live_keys(self) -> torch.Tensor:
        return self.node_count.sum(dtype=torch.int64)

    def total_nodes(self) -> torch.Tensor:
        return self.num_nodes.sum(dtype=torch.int64)

    def memory_bytes(self) -> int:
        """Allocated footprint in bytes (QTMF denominator)."""
        total = 0
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if arr is not None:
                total += arr.numel() * arr.element_size()
        return total

    def bucket_lower_fence(self) -> torch.Tensor:
        """mkba shifted right: bucket b covers keys in (fence[b], mkba[b]]."""
        head = torch.full((1,), MIN_KEY, dtype=KEY_DTYPE, device=self.device)
        return torch.cat([head, self.mkba[:-1]])


def state_to_numpy(state: FliXState) -> dict:
    """The seven carry-over fields as host numpy arrays, plus the expiry
    plane and the successor cache when the state carries them."""
    out = {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}
    for f in OPTIONAL_FIELDS:
        if getattr(state, f) is not None:
            out[f] = getattr(state, f).cpu().numpy()
    return out


def state_from_numpy(arrays: dict, device) -> FliXState:
    """Build a state from host arrays of the seven carry-over fields — e.g.
    ``np.asarray`` of each field of the JAX reference's state — and of the
    optional ones (``exps``, ``succ_smin``, ``succ_sidx``) where the dict
    holds them and they are not None."""
    dev = resolve_device(device)
    out = {}
    for f in STATE_FIELDS + OPTIONAL_FIELDS:
        if f not in STATE_FIELDS and arrays.get(f) is None:
            continue
        a = np.asarray(arrays[f])
        a = a.astype(bool) if f == "needs_restructure" else a.astype(np.int32)
        out[f] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return FliXState(**out)


def empty_state(
    num_buckets: int, nodes_per_bucket: int, node_size: int, *, device=None
) -> FliXState:
    """An all-empty FliX instance with the given static geometry.  Every
    fence is ``MAX_VALID``: routing uses searchsorted(side='left'), which
    tolerates equal fences, so inserts land in bucket 0 until a build or a
    restructure assigns ranges."""
    dev = resolve_device(device)
    nb, npb, ns = num_buckets, nodes_per_bucket, node_size
    return FliXState(
        keys=torch.full((nb, npb, ns), EMPTY, dtype=KEY_DTYPE, device=dev),
        vals=torch.zeros((nb, npb, ns), dtype=VAL_DTYPE, device=dev),
        node_count=torch.zeros((nb, npb), dtype=torch.int32, device=dev),
        node_max=torch.full((nb, npb), EMPTY, dtype=KEY_DTYPE, device=dev),
        num_nodes=torch.zeros((nb,), dtype=torch.int32, device=dev),
        mkba=torch.full((nb,), MAX_VALID, dtype=KEY_DTYPE, device=dev),
        needs_restructure=torch.zeros((), dtype=torch.bool, device=dev),
    )


def sort_bucket_rows(flat_k: torch.Tensor, flat_v: torch.Tensor):
    """Sort each [nb, cap] bucket row ascending (vals follow their key).
    EMPTY is int32 max, so padding lands at the end of every row."""
    out_k = torch.empty_like(flat_k)
    out_v = torch.empty_like(flat_v)
    for c0, c1 in bucket_chunks(flat_k.shape[0], flat_k.shape[1]):
        order = torch.argsort(flat_k[c0:c1], dim=1, stable=True)
        out_k[c0:c1] = torch.gather(flat_k[c0:c1], 1, order)
        out_v[c0:c1] = torch.gather(flat_v[c0:c1], 1, order)
    return out_k, out_v


def flatten_bucket_sorted(state: FliXState) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket flattened (keys, vals), sorted ascending with EMPTY at end.

    Node rows are sorted and chain-ordered (I1+I2), but interior EMPTY
    padding breaks global sortedness, so each bucket row is re-sorted.
    Shape: [nb, npb*ns].
    """
    nb = state.num_buckets
    return sort_bucket_rows(state.keys.reshape(nb, -1), state.vals.reshape(nb, -1))
