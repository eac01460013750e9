"""The paper's experimental baselines (§5.1) in torch (port of
``repro/core/baselines``).

* ``sorted_array``  — full-rebuild GPU Sorted Array (merge on insert).
* ``lsm``           — LSMu: the authors' improved GPU LSM-tree (levels +
                      cascade merge, in-place value tombstones, successor).
* ``btree``         — B-link-style tree: the same data layer as FliX, but
                      queries *traverse an index layer* and updates pay
                      index maintenance.
* ``hash_table``    — Warpcore-style open addressing (fixed capacity, load
                      factor, tombstone deletion, probe-chain misses).

Each is the reference's module with its names, signatures, semantics and
``memory_bytes()`` accounting, so that QTMF (queries/s per byte) means the
same in both packages.  None has a kernel of its own: they are plain torch
emulations of the baselines, as the reference's are jnp emulations, and
their times on the card are not those of Awad et al.'s B-tree, LSMu or
WarpCore.  Each module's ``state_from_numpy(arrays, device)`` carries a
state across from host arrays (e.g. ``np.asarray`` of a reference state's
fields).
"""

from repro_torch.core.baselines import btree, hash_table, lsm, sorted_array  # noqa: F401
