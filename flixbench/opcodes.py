"""The index's operation encoding and sentinels, as its API defines them.

The generators write raw operations in this encoding and the reference
reads it; neither imports the program for it (``tests/test_yardstick.py``
holds these values to the program's).
"""

INSERT = 0
DELETE = 1
POINT = 2
SUCCESSOR = 3
NOP = 4
RANGE = 5  # key = lo, val = hi: the half-open [lo, hi)

EMPTY = 2**31 - 1  # no key / an empty slot
MAX_VALID = EMPTY - 1  # the largest storable key
NOT_FOUND = -1  # a read's miss
