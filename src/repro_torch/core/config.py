"""ExecConfig: the one execution-configuration surface (port of
``repro/core/config.py``).

Every knob is execution strategy, never semantics: two runs of the same
batch under different configs give the same results.  The port takes
``config=`` only; the reference's deprecated per-keyword shims have no
callers here.

``block_b`` and ``tile_table`` reach the staged stripe kernel
(``csrc/flix_apply_staged.cu``), which reads ``block_b`` as its warps a
block: the buckets one block holds in flight, as the TPU kernel's ``block_b``
is the bucket stripes one grid step holds.  ``block_q`` (ops a window) has
no counterpart on the card: a warp finds its op slice from the batch's
per-bucket bounds.  It is kept, with the table's four columns, so that one
config object and one tile table serve both packages.
"""

from __future__ import annotations

import dataclasses

DEFAULT_MAX_RESULTS = 128  # per-batch RANGE output budget (static)


def _pow2_bucket(n: int) -> int:
    """Smallest power of two ≥ n (≥ 1) — the TileTable's size-bucketing."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class TileTable:
    """Autotuned (block_q, block_b) per (build_size, batch_size) bucket.

    ``entries`` rows are ``(build_bucket, batch_bucket, block_q, block_b)``
    with power-of-two buckets; lookups round both sizes *up* to their
    bucket and fall back to the nearest recorded bucket.
    """

    entries: tuple[tuple[int, int, int, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "entries", tuple(tuple(int(x) for x in row) for row in self.entries)
        )

    def lookup(self, build_size: int, batch_size: int) -> tuple[int, int] | None:
        """The tiles for the nearest recorded bucket (None on an empty table).

        Distance is measured in octaves on both axes, with a deterministic
        tie-break on the sorted entry order.
        """
        if not self.entries:
            return None
        want_b = _pow2_bucket(build_size).bit_length()
        want_q = _pow2_bucket(batch_size).bit_length()
        best = min(
            sorted(self.entries),
            key=lambda row: (
                abs(row[0].bit_length() - want_b) + abs(row[1].bit_length() - want_q),
                row,
            ),
        )
        return best[2], best[3]

    def to_json(self) -> list[list[int]]:
        return [list(row) for row in sorted(self.entries)]

    @classmethod
    def from_json(cls, rows) -> "TileTable":
        return cls(entries=tuple(tuple(int(x) for x in row) for row in rows or ()))


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution strategy for one engine call chain.  Frozen + hashable.

    ``impl``         — ``"auto" | "fused" | "reference"`` executor choice.
    ``pipeline``     — the fused path's stripe kernel: ``"on"`` the staged
                       one (``csrc/flix_apply_staged.cu``: a warp per bucket
                       in persistent blocks, the warp's next bucket's rows
                       copied in by ``cp.async`` while the current one
                       merges), ``"off"`` the
                       single-buffer one (a block per bucket), ``"auto"``
                       what :meth:`resolve_pipeline` fixes for the device.
                       Both compute the same function; on the CPU both run
                       the one plain version.  The single-buffer kernel is
                       the slower one on the card and stays as the
                       counterpart of the reference's ``_apply_kernel`` and
                       as a second witness of the staged kernel's function.
    ``donate``       — whether the fused path's staged kernel may write the
                       result into the input state's planes (its donated
                       pass writes only what the batch changes).  True
                       donates, False never does, None
                       leaves it to the entry point: ``apply_ops`` does not
                       donate, ``apply_ops_safe``, which replaces its
                       caller's state, does.  The reference engine, the
                       single-buffer kernel and the TTL path ignore it.
    ``block_b``/``tile_table`` — the staged kernel's warps a block (1 to
                       8; None and 0 keep the kernel's own count), explicit
                       or from the table (:meth:`resolve_blocks`,
                       ``kernels/autotune.py``); the single-buffer kernel
                       and the plain version do not read it.
    ``block_q``      — the TPU kernel's ops a window; no counterpart here.
    ``max_results``  — per-batch dense RANGE output budget (static).
    ``capacity``/``routing`` — sharded-engine knobs, unread by this slice.
    ``validate``     — run ``check_invariants`` on results (``apply_ops_safe``).
    ``validate_ranges`` — run ``check_range_results`` (``apply_ops_safe``).
    """

    impl: str = "auto"
    pipeline: str = "auto"
    donate: bool | None = None
    block_q: int | None = None
    block_b: int | None = None
    tile_table: TileTable | None = None
    max_results: int = DEFAULT_MAX_RESULTS
    capacity: int | None = None
    routing: str = "replicated"
    validate: bool = False
    validate_ranges: bool = False

    def __post_init__(self):
        if self.impl not in ("auto", "fused", "reference"):
            raise ValueError(f"unknown impl: {self.impl!r}")
        if self.pipeline not in ("auto", "on", "off"):
            raise ValueError(f"unknown pipeline mode: {self.pipeline!r}")
        if self.routing not in ("replicated", "a2a"):
            raise ValueError(f"unknown routing: {self.routing!r}")

    def replace(self, **kw) -> "ExecConfig":
        return dataclasses.replace(self, **kw)

    def resolve_pipeline(self, device) -> bool:
        """Whether the fused path runs the staged stripe kernel.  ``"auto"``
        follows the reference, which takes the double-buffered kernel on
        its accelerator: the staged kernel on CUDA.  Fixed in code, with no
        timing at run time."""
        if self.pipeline == "auto":
            return getattr(device, "type", str(device)) == "cuda"
        return self.pipeline == "on"

    def resolve_blocks(
        self, build_size: int, batch_size: int
    ) -> tuple[int | None, int | None]:
        """The (block_q, block_b) of a launch: explicit overrides win, then
        the tile table, then (None, None).  The staged kernel takes block_b
        as its warps a block; block_q has no reader on the card."""
        bq, bb = self.block_q, self.block_b
        if (bq is None or bb is None) and self.tile_table is not None:
            hit = self.tile_table.lookup(build_size, batch_size)
            if hit is not None:
                bq = bq if bq is not None else hit[0]
                bb = bb if bb is not None else hit[1]
        return bq, bb
