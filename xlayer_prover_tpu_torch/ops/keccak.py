"""Keccak-f[1600] permutation and Keccak-256: host-exact and batched torch.

The port's own copy of ``xlayer_prover_tpu/ops/keccak.py``.  The host
permutation ``_host_keccak_f`` (Python ints) serves the executor's hashK
digests (``keccak256``, re-exported by ``utils/keccak.py``), the PaddingKK
sponge and the Keccak chain's replay; ``keccak_f`` is the same
permutation batched over a tensor of states as plain torch ops on int64
lanes (a lane's 64 bits in two's complement), on the tensor's device.

Round constants and rotation offsets are derived from the Keccak
specification (the rc(t) LFSR, the rho schedule).
"""

from __future__ import annotations

import functools

import torch

NUM_ROUNDS = 24
MASK64 = (1 << 64) - 1
RATE_BYTES = 136            # 1088-bit rate of Keccak-256


@functools.lru_cache(maxsize=None)
def round_constants():
    """RC[24] via the rc(t) LFSR from the Keccak reference spec."""
    def rc_bit(t):
        if t % 255 == 0:
            return 1
        r = 1
        for _ in range(t % 255):
            r <<= 1
            if r & 0x100:
                r ^= 0x171
        return r & 1

    out = []
    for ir in range(NUM_ROUNDS):
        rc = 0
        for j in range(7):
            if rc_bit(j + 7 * ir):
                rc |= 1 << ((1 << j) - 1)
        out.append(rc)
    return out


@functools.lru_cache(maxsize=None)
def rotation_offsets():
    """r[x][y] from the rho schedule: (x,y)=(1,0); t: rot=(t+1)(t+2)/2."""
    r = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        r[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return r


@functools.lru_cache(maxsize=None)
def _lane_tables():
    """(rho[25], pi_src[25]) over lane index x + 5y: the rotation of each
    lane, and the lane that moves INTO each slot under pi."""
    rot = rotation_offsets()
    rho = [0] * 25
    pi_src = [0] * 25
    for x in range(5):
        for y in range(5):
            rho[x + 5 * y] = rot[x][y]
            # B[y][(2x+3y)%5] = A[x][y]
            pi_src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return rho, pi_src


# ---------------------------------------------------------------------------
# Host-exact implementation (python ints)
# ---------------------------------------------------------------------------

def _host_keccak_f(lanes):
    """lanes: list of 25 ints (index x + 5*y). Returns permuted list."""
    rho, pi_src = _lane_tables()
    a = list(lanes)
    for rc in round_constants():
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1)
                                | (c[(x + 1) % 5] >> 63)) & MASK64)
             for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for i in range(25):
            v, n = a[pi_src[i]], rho[pi_src[i]]
            b[i] = ((v << n) | (v >> (64 - n))) & MASK64 if n else v
        # chi + iota
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & MASK64
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """EVM keccak-256 (rate 136, multi-rate padding 0x01 .. 0x80)."""
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 \
        else b"\x81"
    lanes = [0] * 25
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off:off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            lanes[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        lanes = _host_keccak_f(lanes)
    return b"".join(lanes[i].to_bytes(8, "little") for i in range(4))


# ---------------------------------------------------------------------------
# Batched permutation (torch, int64 lanes)
# ---------------------------------------------------------------------------

def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """state: (batch, 25) int64 lanes (lane index x + 5*y) on any device.
    Returns the permuted lanes, on the same device.

    Lane-vectorized theta / rho / pi / chi / iota over the batch; a
    logical right shift is an arithmetic one masked to the bits that
    come in, so no lane needs an unsigned type."""
    rho_l, pi_l = _lane_tables()
    dev = state.device
    rho = torch.tensor(rho_l, dtype=torch.int64, device=dev)
    back = torch.tensor([(64 - n) % 64 for n in rho_l], dtype=torch.int64,
                        device=dev)
    low = torch.tensor([(1 << n) - 1 for n in rho_l], dtype=torch.int64,
                       device=dev)
    pi_src = torch.tensor(pi_l, dtype=torch.int64, device=dev)
    rc = [v - (1 << 64) if v >> 63 else v for v in round_constants()]
    a = state.to(torch.int64).reshape(-1, 5, 5)        # [batch][y][x]
    batch = a.shape[0]
    for ir in range(NUM_ROUNDS):
        # theta
        c = a[:, 0] ^ a[:, 1] ^ a[:, 2] ^ a[:, 3] ^ a[:, 4]
        c1 = (c << 1) | ((c >> 63) & 1)
        d = torch.roll(c, 1, dims=-1) ^ torch.roll(c1, -1, dims=-1)
        a = (a ^ d[:, None, :]).reshape(batch, 25)
        # rho (per-lane rotations) + pi (lane permutation)
        a = (a << rho) | ((a >> back) & low)
        b = a[:, pi_src].reshape(batch, 5, 5)
        # chi: A[x][y] = B[x][y] ^ (~B[x+1][y] & B[x+2][y]); x = last axis
        a = b ^ (~torch.roll(b, -1, dims=-1) & torch.roll(b, -2, dims=-1))
        # iota
        a[:, 0, 0] ^= rc[ir]
    return a.reshape(batch, 25)
