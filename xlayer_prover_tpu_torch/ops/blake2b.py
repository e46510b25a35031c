"""Blake2b-256 (reference: tools/sm/blake/blake.cpp, RFC 7693).

The port's copy of ``xlayer_prover_tpu/ops/blake2b.py``: a from-scratch
compression on the host (no hashlib).  The reference ships it as a
standalone tools/sm component with a KAT harness (blake_test.cpp:118-124);
tests/test_torch_zkin_blake.py holds it against the JAX package's and the
reference's vectors, and against the stdlib oracle.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1

IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
]


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & MASK64
    v[d] = _rotr(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & MASK64
    v[b] = _rotr(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & MASK64
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & MASK64
    v[b] = _rotr(v[b] ^ v[c], 63)


def _compress(h, block: bytes, t: int, last: bool):
    m = [int.from_bytes(block[8 * i:8 * i + 8], "little")
         for i in range(16)]
    v = h[:] + IV[:]
    v[12] ^= t & MASK64
    v[13] ^= (t >> 64) & MASK64
    if last:
        v[14] ^= MASK64
    for r in range(12):
        s = SIGMA[r]
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    for i in range(8):
        h[i] ^= v[i] ^ v[i + 8]


def blake2b_256(data: bytes) -> bytes:
    """Unkeyed Blake2b with a 32-byte digest."""
    h = IV[:]
    h[0] ^= 0x01010000 ^ 32          # param block: digest_length=32
    n = len(data)
    if n == 0:
        block = b"\x00" * 128
        _compress(h, block, 0, True)
    else:
        off = 0
        while n - off > 128:
            _compress(h, data[off:off + 128], off + 128, False)
            off += 128
        tail = data[off:]
        block = tail + b"\x00" * (128 - len(tail))
        _compress(h, block, n, True)
    return b"".join(x.to_bytes(8, "little") for x in h[:4])


def blake2b_256_string(s: str) -> str:
    """Hex-string API mirroring Blake2b256_String (blake.cpp): input is
    '0x...' bytes (or empty), output is the 0x-prefixed digest with
    leading zeros trimmed to the reference's normalized form."""
    data = bytes.fromhex(s[2:]) if s.startswith("0x") else \
        bytes.fromhex(s) if s else b""
    digest = int.from_bytes(blake2b_256(data), "big")
    return hex(digest)
