"""Keccak-256 on the host, in pure Python.

The executor's hashK digests (``executor/main_sm.py``) need the Ethereum
Keccak-256: Keccak-f[1600] with a 1088-bit rate and the original padding
0x01 ... 0x80.  ``hashlib.sha3_256`` pads with 0x06 and gives other
digests.  The JAX package calls its native C helper for this; the port
keeps one plain version, in ``ops/keccak.py``, which a test holds against
that helper.  This module re-exports it.
"""

from __future__ import annotations

from ..ops.keccak import keccak256  # noqa: F401
