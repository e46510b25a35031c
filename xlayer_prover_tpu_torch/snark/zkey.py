"""snarkjs .zkey (Groth16) binary format: reader + writer.

The port's copy of ``xlayer_prover_tpu/snark/zkey.py`` (the reference's
zkey loader, src/rapidsnark/zkey_utils.cpp + binfile_utils): the proving
key the reference downloads in its artifact archive ships in this
container format, so externally provided keys drop into
``snark/groth16.py``, and the port's own setups persist in the same
format.  The container holds host Python ints; ``from_setup`` reads the
port's device-resident ProvingKey through ``groth16.keys_to_host``, and
``to_keys`` returns one (``groth16.keys_from_host``).

Layout (BinFile): magic "zkey", version u32, nSections u32; each section:
id u32, length u64, payload.  Sections (groth16): 1 = protocol id (1);
2 = header (n8q, q LE, n8r, r LE, nVars, nPublic, domainSize, alpha1,
beta1, beta2, gamma1, delta1, gamma2(?), delta2 — point order per
zkey_utils.cpp: alpha1, beta1, beta2, gamma2, delta1, delta2); 3 = IC;
4 = coeffs (A/B sparse matrices); 5..9 = PointsA/B1/B2/C/H; points are
affine coordinate pairs, each coordinate n8 little-endian bytes in
MONTGOMERY form (x * 2^(8*n8) mod p).
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List, Optional, Tuple

from ..fields.bn254 import P as Q          # base field
from ..fields.bn254 import R               # scalar field

N8Q = 32
N8R = 32
R_Q = (1 << 256) % Q                       # Montgomery radix mod q
R_R = (1 << 256) % R
R_Q_INV = pow(R_Q, Q - 2, Q)
R_R_INV = pow(R_R, R - 2, R)

MAGIC = b"zkey"


def _mont_q(v: int) -> bytes:
    return (v * R_Q % Q).to_bytes(N8Q, "little")


def _unmont_q(b: bytes) -> int:
    return int.from_bytes(b, "little") * R_Q_INV % Q


def _mont_r(v: int) -> bytes:
    return (v * R_R % R).to_bytes(N8R, "little")


def _unmont_r(b: bytes) -> int:
    return int.from_bytes(b, "little") * R_R_INV % R


def _write_g1(buf, pt: Optional[Tuple[int, int]]):
    if pt is None:
        buf.write(b"\x00" * (2 * N8Q))
    else:
        buf.write(_mont_q(pt[0]))
        buf.write(_mont_q(pt[1]))


def _read_g1(buf) -> Optional[Tuple[int, int]]:
    x = _unmont_q(buf.read(N8Q))
    y = _unmont_q(buf.read(N8Q))
    if x == 0 and y == 0:
        return None
    return (x, y)


def _write_g2(buf, pt):
    if pt is None:
        buf.write(b"\x00" * (4 * N8Q))
        return
    (x0, x1), (y0, y1) = pt
    for v in (x0, x1, y0, y1):
        buf.write(_mont_q(v))


def _read_g2(buf):
    vals = [_unmont_q(buf.read(N8Q)) for _ in range(4)]
    if all(v == 0 for v in vals):
        return None
    return ((vals[0], vals[1]), (vals[2], vals[3]))


@dataclasses.dataclass
class ZKey:
    n_vars: int
    n_public: int
    domain_size: int
    alpha1: tuple
    beta1: tuple
    beta2: tuple
    gamma2: tuple
    delta1: tuple
    delta2: tuple
    ic: list
    coeffs: List[Tuple[int, int, int, int]]   # (matrix, constraint, signal, value)
    a_query: list
    b1_query: list
    b2_query: list
    c_query: list
    h_query: list


def write_zkey(zk: ZKey, path: str):
    sections = []

    sec1 = struct.pack("<I", 1)                      # groth16
    sections.append((1, sec1))

    buf = io.BytesIO()
    buf.write(struct.pack("<I", N8Q))
    buf.write(Q.to_bytes(N8Q, "little"))
    buf.write(struct.pack("<I", N8R))
    buf.write(R.to_bytes(N8R, "little"))
    buf.write(struct.pack("<III", zk.n_vars, zk.n_public, zk.domain_size))
    _write_g1(buf, zk.alpha1)
    _write_g1(buf, zk.beta1)
    _write_g2(buf, zk.beta2)
    _write_g2(buf, zk.gamma2)
    _write_g1(buf, zk.delta1)
    _write_g2(buf, zk.delta2)
    sections.append((2, buf.getvalue()))

    buf = io.BytesIO()
    for pt in zk.ic:
        _write_g1(buf, pt)
    sections.append((3, buf.getvalue()))

    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(zk.coeffs)))
    for (m, c, s, v) in zk.coeffs:
        buf.write(struct.pack("<III", m, c, s))
        buf.write(_mont_r(v))
    sections.append((4, buf.getvalue()))

    for sec_id, pts, g2 in ((5, zk.a_query, False), (6, zk.b1_query, False),
                            (7, zk.b2_query, True), (8, zk.c_query, False),
                            (9, zk.h_query, False)):
        buf = io.BytesIO()
        for pt in pts:
            if g2:
                _write_g2(buf, pt)
            else:
                _write_g1(buf, pt)
        sections.append((sec_id, buf.getvalue()))

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", 1, len(sections)))
        for (sid, payload) in sections:
            f.write(struct.pack("<IQ", sid, len(payload)))
            f.write(payload)


def read_zkey(path: str) -> ZKey:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError("not a zkey file")
    _version, n_sections = struct.unpack_from("<II", data, 4)
    pos = 12
    sections = {}
    for _ in range(n_sections):
        sid, length = struct.unpack_from("<IQ", data, pos)
        pos += 12
        sections[sid] = data[pos:pos + length]
        pos += length

    (protocol,) = struct.unpack_from("<I", sections[1], 0)
    if protocol != 1:
        raise ValueError("zkey is not groth16")

    buf = io.BytesIO(sections[2])
    (n8q,) = struct.unpack("<I", buf.read(4))
    q = int.from_bytes(buf.read(n8q), "little")
    (n8r,) = struct.unpack("<I", buf.read(4))
    r = int.from_bytes(buf.read(n8r), "little")
    if q != Q or r != R:
        raise ValueError("zkey curve is not BN254")
    n_vars, n_public, domain_size = struct.unpack("<III", buf.read(12))
    alpha1 = _read_g1(buf)
    beta1 = _read_g1(buf)
    beta2 = _read_g2(buf)
    gamma2 = _read_g2(buf)
    delta1 = _read_g1(buf)
    delta2 = _read_g2(buf)

    buf = io.BytesIO(sections[3])
    ic = [_read_g1(buf) for _ in range(n_public + 1)]

    buf = io.BytesIO(sections[4])
    (n_coeffs,) = struct.unpack("<I", buf.read(4))
    coeffs = []
    for _ in range(n_coeffs):
        m, c, s_ = struct.unpack("<III", buf.read(12))
        v = _unmont_r(buf.read(N8R))
        coeffs.append((m, c, s_, v))

    def read_pts(sec, g2=False):
        b = io.BytesIO(sections[sec])
        size = 4 * N8Q if g2 else 2 * N8Q
        n = len(sections[sec]) // size
        return [(_read_g2(b) if g2 else _read_g1(b)) for _ in range(n)]

    return ZKey(n_vars=n_vars, n_public=n_public, domain_size=domain_size,
                alpha1=alpha1, beta1=beta1, beta2=beta2, gamma2=gamma2,
                delta1=delta1, delta2=delta2, ic=ic, coeffs=coeffs,
                a_query=read_pts(5), b1_query=read_pts(6),
                b2_query=read_pts(7, g2=True), c_query=read_pts(8),
                h_query=read_pts(9))


# ---------------------------------------------------------------------------
# bridges to snark/groth16.py key objects
# ---------------------------------------------------------------------------

def from_setup(pk, vk, r1cs) -> ZKey:
    """groth16.(ProvingKey, VerifyingKey) + R1CS -> ZKey container."""
    from .groth16 import keys_to_host
    pk, vk = keys_to_host(pk, vk)
    coeffs = []
    for ci, (a, b, _c) in enumerate(r1cs.constraints):
        for s_, v in a.items():
            coeffs.append((0, ci, s_, v))
        for s_, v in b.items():
            coeffs.append((1, ci, s_, v))
    return ZKey(
        n_vars=pk.n_wires, n_public=pk.n_public,
        domain_size=1 << pk.domain_bits,
        alpha1=pk.alpha1, beta1=pk.beta1, beta2=pk.beta2,
        gamma2=vk.gamma2, delta1=pk.delta1, delta2=pk.delta2,
        ic=list(vk.ic), coeffs=coeffs,
        a_query=list(pk.a_query), b1_query=list(pk.b1_query),
        b2_query=list(pk.b2_query),
        c_query=[p for p in pk.c_query],
        h_query=list(pk.h_query))


def to_keys(zk: ZKey, device=None):
    """ZKey -> (ProvingKey, VerifyingKey) for snark/groth16.py, the
    queries on `device` (None: the card)."""
    from .groth16 import HostProvingKey, VerifyingKey, keys_from_host
    domain_bits = (zk.domain_size - 1).bit_length()
    c_query = list(zk.c_query)
    # align c_query with wire indexing: public wires have no C entries
    if len(c_query) == zk.n_vars - zk.n_public - 1:
        c_query = [None] * (zk.n_public + 1) + c_query
    pk = HostProvingKey(
        n_public=zk.n_public, n_wires=zk.n_vars, domain_bits=domain_bits,
        alpha1=zk.alpha1, beta1=zk.beta1, beta2=zk.beta2,
        delta1=zk.delta1, delta2=zk.delta2,
        a_query=list(zk.a_query), b1_query=list(zk.b1_query),
        b2_query=list(zk.b2_query), c_query=c_query,
        h_query=list(zk.h_query))
    vk = VerifyingKey(alpha1=zk.alpha1, beta2=zk.beta2, gamma2=zk.gamma2,
                      delta2=zk.delta2, ic=list(zk.ic))
    return keys_from_host(pk, vk, device)
