"""Atomic directory commits (port of ``repro/checkpoint/manager.py``).

Only ``tmp_sibling`` is ported: the durable FliX layer commits every
snapshot through it.  The reference's pytree checkpoints of the LM trainer
(``save_pytree``, ``restore_pytree``, ``CheckpointManager``) are ported
with the trainer itself.
"""

from __future__ import annotations

import itertools
import os
from pathlib import Path

_TMP_COUNTER = itertools.count()


def tmp_sibling(path: Path) -> Path:
    """A unique scratch sibling for atomic directory commits.

    ``path.with_suffix(".tmp")`` mangles dotted names (``step_0.5k`` →
    ``step_0.tmp``) and collides across concurrent savers; appending a
    ``.tmp-<pid>-<counter>`` suffix to the *full* name does neither.  Names
    containing ``.tmp`` are skipped by every directory listing here, so an
    abandoned scratch dir from a crashed save is inert until its owner (or
    a fresh save of the same target) cleans it up.
    """
    path = Path(path)
    return path.parent / f"{path.name}.tmp-{os.getpid()}-{next(_TMP_COUNTER)}"
