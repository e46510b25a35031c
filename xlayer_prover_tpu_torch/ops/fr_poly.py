"""BN254 Fr polynomial kernels of the fflonk prover.

The port's counterparts of the host Python of the JAX package's fflonk
prover (``xlayer_prover_tpu/snark/fflonk.py``): ``peval`` (:88),
``pdiv_zh`` (:95) and ``pdivmod`` (:107) by binomials, the running
products (tau^i :210, w^i :226 and :285, ``_shift_omega`` :123, z's grand
product :326), and the pointwise steps of its ``pmul`` / ``padd`` chains
(:306-311, :339-347).  Tensors hold (n, 4) int64 canonical little-endian
Fr words (``ops/bn254_mont.to_words``).

  * ``evaluate(p, points)``: [p(x) for x in points], Python ints.
  * ``div_binomial(p, k, c)``: (q, r) with p = q (X^k - c) + r, q of
    max(1, n - k) values and r of k; the JAX ``pdivmod`` asserts that
    r = 0 where it divides exactly, and so do the callers here.
  * ``scan_mul(x, exclusive, init, n, reverse)``: init times the prefix
    products of x (inclusive, or exclusive from init), or with
    ``reverse`` its suffix products; with ``n``, x is one value repeated
    n times, so the result is init x^i (in that order only).
  * ``pointwise(op, inputs, consts, ...)``: one identity of PW_OPS over
    the inputs' values: ``lincomb`` (sum_j k_j x_j, each input zero past
    its own length), ``mul`` (k x_0 x_1), ``gate`` (qM a b + qL a + qR b +
    qO c + qC + pi), ``perm_z`` (the permutation's numerator and
    denominator at the domain's points), ``perm_t2`` (z numerator - z(w x)
    denominator).

On a CUDA tensor each launches its kernel of ``csrc/fr_poly.cu`` (one
count in ``kernels.LAUNCHES`` a call, whatever its device launches), and
raises if the library does not build or a launch fails; on a CPU tensor it
runs its plain PyTorch version (``_*_plain``, over ``bn254_mont.FR``).
``_*_model`` are the same functions on Python ints, which the CPU tests
hold both against.  No PyTorch call computes any of them: the integer
ops and ``torch.cumprod`` wrap modulo 2^64, and r is 254 bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from ..fields.bn254 import R
from .bn254_mont import FR, L, MONT, from_words, to_words

# csrc/fr_poly.cu's constants (a CPU test reads them there)
EVAL_POINTS = 8
EVAL_THREADS = 128
EVAL_SEG = 16
EVAL_SQ = 11
EVAL_MIN_BLOCKS = 4
EVAL_TILE = EVAL_THREADS * EVAL_SEG      # coefficients a fr_eval tile
POW_SQ = 32
POW_THREADS = 512
LIN_MAX_K = 8
LB_THREADS = 128
LB_STEPS = 16
LB_WINDOW = 32
PW_INPUTS = 9
PW_CONSTS = 6
PW_OPS = {"lincomb": 0, "mul": 1, "gate": 2, "perm_z": 3, "perm_t2": 4}
K1, K2 = 2, 3                   # the permutation's coset shifts
DOMAIN_LO_BITS = 14             # the domain tables: 2^14 low powers
PW_THREADS = 128                # fr_pointwise: a value a thread


def _mont(v: int) -> int:
    return v % R * MONT % R


def _words_arg(values) -> ctypes.Array:
    """Python ints -> a host array of their 8 x 32-bit words each."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    arr = (ctypes.c_uint32 * (len(raw) // 4))()
    ctypes.memmove(arr, raw, len(raw))
    return arr


def _check(name: str, *ts):
    for t in ts:
        if t.dim() != 2 or t.shape[1] != 4 or t.dtype != torch.int64:
            raise ValueError(f"{name}: (n, 4) int64 words expected, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on different devices")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors expected")


def _lib():
    return kernels.load("fr_poly")


def _launch(fn: str, *args):
    kernels.check(getattr(_lib(), fn)(*args), fn)


# ---------------------------------------------------------------------------
# Python-int models
# ---------------------------------------------------------------------------

def _eval_model(p: list, x: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % R
    return acc


def _div_binomial_model(p: list, k: int, c: int):
    """(q, r): p = q (X^k - c) + r, q of max(1, n - k) values, r of k."""
    n = len(p)
    q = [0] * max(1, n - k)
    for j in range(n - k - 1, -1, -1):
        q[j] = (p[j + k] + c * (q[j + k] if j + k < n - k else 0)) % R
    r = [((p[j] if j < n else 0) + c * (q[j] if j < n - k else 0)) % R
         for j in range(k)]
    return q, r


def _scan_mul_model(x: list, exclusive: bool, init: int = 1,
                    reverse: bool = False) -> list:
    if reverse:
        return _scan_mul_model(x[::-1], exclusive, init)[::-1]
    out, acc = [], init % R
    for v in x:
        if exclusive:
            out.append(acc)
        acc = acc * v % R
        if not exclusive:
            out.append(acc)
    return out


def _domain_model(n: int, w: int) -> list:
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * w % R
    return out


def _pointwise_model(op: str, inputs: list, consts: list, w: int = 1,
                     shift: int = 0):
    """The identities on Python-int lists; ``consts`` as Python ints
    (lincomb: the k_j; mul: k; perm_*: beta, gamma), `w` the domain's
    generator.  -> a list (perm_z: (numerator, denominator))."""
    n = max(len(x) for x in inputs) if op == "lincomb" else len(inputs[0])

    def at(x, i):
        return x[i] if i < len(x) else 0
    if op == "lincomb":
        return [sum(k * at(x, i) for k, x in zip(consts, inputs)) % R
                for i in range(n)]
    if op == "mul":
        return [consts[0] * a * b % R for a, b in zip(*inputs)]
    if op == "gate":
        qm, ql, qr, qo, qc, a, b, c, pi = inputs
        return [(qm[i] * a[i] * b[i] + ql[i] * a[i] + qr[i] * b[i]
                 + qo[i] * c[i] + qc[i] + pi[i]) % R for i in range(n)]
    beta, gamma = consts
    xs = _domain_model(n, w)
    a, b, c, s1, s2, s3 = inputs[:6]
    num = [(a[i] + beta * xs[i] + gamma) * (b[i] + beta * K1 * xs[i] + gamma)
           * (c[i] + beta * K2 * xs[i] + gamma) % R for i in range(n)]
    den = [(a[i] + beta * s1[i] + gamma) * (b[i] + beta * s2[i] + gamma)
           * (c[i] + beta * s3[i] + gamma) % R for i in range(n)]
    if op == "perm_z":
        return num, den
    z = inputs[6]
    return [(z[i] * num[i] - z[(i + shift) % n] * den[i]) % R
            for i in range(n)]


# ---------------------------------------------------------------------------
# Plain PyTorch versions (bn254_mont.FR limbs, R' = 2^272)
# ---------------------------------------------------------------------------

def _const(v: int, like: torch.Tensor) -> torch.Tensor:
    return FR.const(v % R, like.device).expand_as(like)


def _sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The sum of (m, L) Montgomery limbs, as (L,) limbs (a pairwise tree,
    reduced at every level)."""
    if x.shape[0] == 0:
        return FR.const(0, x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, FR.const(0, x.device)[None]])
        x = FR.reduce(FR.add(x[0::2], x[1::2]))
    return x[0]


def _powers_plain(x: int, n: int, device, init: int = 1) -> torch.Tensor:
    """(n, L) Montgomery limbs of init x^i, by doubling."""
    table = FR.const(init % R, device).reshape(1, L)
    step = x % R
    while table.shape[0] < n:
        table = torch.cat([table, FR.mul(table, FR.const(step, device)
                                         .expand_as(table))])
        step = step * step % R
    return table[:n]


def _eval_plain(p: torch.Tensor, points) -> list:
    """Plain PyTorch version of the fr_eval kernel."""
    pm = FR.to_mont(p)
    out = []
    for x in points:
        terms = FR.mul(pm, _powers_plain(x, p.shape[0], p.device))
        out.append(from_words(FR.from_mont(_sum_plain(terms)[None]))[0])
    return out


def _scan_mul_plain(x: torch.Tensor, exclusive: bool, init: int,
                    n: int | None, reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the fr_scan_mul kernels: a log-step scan
    (x one value repeated n times when `n` is given; `reverse`: the
    suffix products, the scan of x reversed, reversed)."""
    if reverse:
        return torch.flip(_scan_mul_plain(torch.flip(x, [0]), exclusive,
                                          init, n), [0])
    if n is not None:
        y = _powers_plain(from_words(x[:1])[0], n + 1, x.device, init)
        return FR.from_mont(y[:n] if exclusive else y[1:])
    y = FR.to_mont(x)
    s = 1
    while s < y.shape[0]:
        nxt = y.clone()
        nxt[s:] = FR.mul(y[s:], y[:-s])
        y, s = nxt, 2 * s
    y = FR.mul(y, _const(init, y))
    if exclusive:
        y = torch.cat([FR.const(init % R, x.device)[None], y[:-1]])
    return FR.from_mont(y)


def _lin_scan_plain(u: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """y_j = u_j + c y_{j+k} over (m, L) Montgomery limbs, by doubling:
    after a step of span d, y_j = U_j + c^(d/k) y_{j+d}."""
    y = u
    m, d, cd = u.shape[0], k, c % R
    while d < m:
        nxt = y.clone()
        nxt[:m - d] = FR.reduce(FR.add(y[:m - d], FR.mul(
            y[d:], FR.const(cd, u.device).expand_as(y[d:]))))
        y, d, cd = nxt, 2 * d, cd * cd % R
    return y


def _div_binomial_plain(p: torch.Tensor, k: int, c: int):
    """Plain PyTorch version of the fr_div_binomial kernels."""
    n, dev = p.shape[0], p.device
    pm = FR.to_mont(p)

    def padded(x, rows):
        return torch.cat([x[:rows], torch.zeros(
            (max(0, rows - x.shape[0]), L), dtype=torch.int64, device=dev)])
    if n > k:
        q = _lin_scan_plain(pm[k:], k, c)
        q_lo = padded(q, k)
    else:
        q = torch.zeros((1, L), dtype=torch.int64, device=dev)
        q_lo = torch.zeros((k, L), dtype=torch.int64, device=dev)
    r = FR.reduce(FR.add(padded(pm, k), FR.mul(q_lo, _const(c, q_lo))))
    return FR.from_mont(q), FR.from_mont(r)


def _pointwise_plain(op: str, inputs, consts, w: int, shift: int):
    """Plain PyTorch version of the fr_pointwise kernel."""
    if op == "lincomb":
        n = max(x.shape[0] for x in inputs)
        acc = None
        for k, x in zip(consts, inputs):
            xm = FR.to_mont(torch.cat([x, x.new_zeros((n - x.shape[0], 4))]))
            t = FR.mul(xm, _const(k, xm))
            acc = t if acc is None else FR.reduce(FR.add(acc, t))
        return FR.from_mont(acc)
    ms = [FR.to_mont(x) for x in inputs]
    if op == "mul":
        return FR.from_mont(FR.mul(FR.mul(ms[0], ms[1]),
                                   _const(consts[0], ms[0])))
    if op == "gate":
        qm, ql, qr, qo, qc, a, b, c, pi = ms
        acc = FR.mul(FR.mul(qm, a), b)
        for s in (FR.mul(ql, a), FR.mul(qr, b), FR.mul(qo, c), qc, pi):
            acc = FR.reduce(FR.add(acc, s))
        return FR.from_mont(acc)
    beta, gamma = consts
    a, b, c, s1, s2, s3 = ms[:6]
    x = _powers_plain(w, a.shape[0], a.device)
    g = _const(gamma, a)

    def factor(v, t, k):
        return FR.add(FR.add(v, FR.mul(t, _const(beta * k, t))), g)

    num = FR.mul(FR.mul(factor(a, x, 1), factor(b, x, K1)),
                 factor(c, x, K2))
    den = FR.mul(FR.mul(factor(a, s1, 1), factor(b, s2, 1)),
                 factor(c, s3, 1))
    if op == "perm_z":
        return FR.from_mont(num), FR.from_mont(den)
    z = ms[6]
    zw = torch.roll(z, -shift, 0)
    return FR.from_mont(FR.sub(FR.mul(z, num), FR.mul(zw, den)))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def evaluate(p: torch.Tensor, points) -> list:
    """[p(x) for x in points] (Python ints) for (n, 4) coefficient words.
    Wrapper of the ``fr_eval`` kernel: a CPU tensor takes the plain
    version."""
    _check("evaluate", p)
    points = [int(x) % R for x in points]
    if p.device.type == "cpu":
        return _eval_plain(p, points)
    if p.shape[0] == 0 or not points:
        return [0] * len(points)
    kernels.LAUNCHES["fr_eval"] += 1
    return _evaluate_launch(p, points)


@functools.lru_cache(maxsize=None)
def _eval_occupancy() -> int:
    """Blocks of eval_pass an SM can hold (at least EVAL_MIN_BLOCKS, its
    launch bounds)."""
    blocks = _lib().fr_eval_occupancy()
    if blocks < 1:
        raise RuntimeError("fr_eval: no occupancy")
    return blocks


def _eval_blocks(n: int, device) -> int:
    """fr_eval's grid over n coefficients: the blocks the card holds at
    once, no more than its tiles, and no more than one tile of the
    finishing pass."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(-(-n // EVAL_TILE), sms * _eval_occupancy(), EVAL_TILE)


def _eval_args(points: list, blocks: int) -> ctypes.Array:
    """fr_eval's EvalArgs, Montgomery form: each point's x^(2^b) for b <
    EVAL_SQ, then each point's x^(EVAL_TILE blocks), EVAL_POINTS of each
    (zeros past the points)."""
    pad = EVAL_POINTS - len(points)
    sq = []
    for x in points:
        for _ in range(EVAL_SQ):
            sq.append(_mont(x))
            x = x * x % R
    ys = [_mont(pow(x, EVAL_TILE * blocks, R)) for x in points]
    return _words_arg(sq + [0] * (EVAL_SQ * pad) + ys + [0] * pad)


def _evaluate_launch(p: torch.Tensor, points: list) -> list:
    """EVAL_POINTS points at a time: one fr_eval pass over p, then (with
    more than one block) one block over the blocks' values, a polynomial
    in x^EVAL_TILE."""
    dev, n = p.device, p.shape[0]
    stream = kernels.stream_ptr(dev)
    blocks = _eval_blocks(n, dev)
    out_vals = []
    for g in range(0, len(points), EVAL_POINTS):
        xs = points[g:g + EVAL_POINTS]
        part = torch.empty((len(xs) * blocks, 4), dtype=torch.int64,
                           device=dev)
        args = _eval_args(xs, blocks)                # alive for the call
        _launch("fr_eval_launch", p.data_ptr(), 0, n, len(xs),
                ctypes.addressof(args), blocks, part.data_ptr(), stream)
        if blocks > 1:
            vals = torch.empty((len(xs), 4), dtype=torch.int64, device=dev)
            fin = _eval_args([pow(x, EVAL_TILE, R) for x in xs], 1)
            _launch("fr_eval_launch", part.data_ptr(), blocks, blocks,
                    len(xs), ctypes.addressof(fin), 1, vals.data_ptr(),
                    stream)
            part = vals
        out_vals += from_words(part)
    return out_vals


def scan_mul(x: torch.Tensor, exclusive: bool = False, init: int = 1,
             n: int | None = None, reverse: bool = False) -> torch.Tensor:
    """init times the prefix products of the (m, 4) words x, inclusive
    (out_i = init x_0 .. x_i) or exclusive (out_i = init x_0 .. x_{i-1}),
    or with `reverse` the suffix products (out_i = init x_i .. x_{m-1},
    or x_{i+1} .. x_{m-1}); with `n`, x (one row) is repeated n times
    (prefix products only).  Wrapper of the ``fr_scan_mul`` kernels: a
    CPU tensor takes the plain version."""
    _check("scan_mul", x)
    if n is not None and (x.shape[0] != 1 or reverse):
        raise ValueError("scan_mul: one value to repeat, forwards, "
                         "expected")
    count = x.shape[0] if n is None else n
    if x.device.type == "cpu":
        return _scan_mul_plain(x, exclusive, init, n, reverse)
    if count == 0:
        return torch.empty((0, 4), dtype=torch.int64, device=x.device)
    kernels.LAUNCHES["fr_scan_mul"] += 1
    return _scan_mul_launch(x, exclusive, init, n, reverse)


def _pow_split(e: int) -> tuple:
    """(L, hi_n) of the repeated scan's tables over exponents below e: e
    = hi 2^L + lo with L about half of e's bits."""
    lo_bits = (max(1, e - 1).bit_length() + 1) // 2
    return lo_bits, -(-e >> lo_bits)


def _scan_mul_launch(x, exclusive: bool, init: int, n, reverse: bool):
    """A vector: one look-back launch (its status words zeroed by the
    launcher).  One value repeated: its two tables, then a product of
    theirs a value."""
    dev = x.device
    stream = kernels.stream_ptr(dev)
    iw = _words_arg([_mont(init)])                   # alive for the call
    if n is None:
        m = x.shape[0]
        out = torch.empty((m, 4), dtype=torch.int64, device=dev)
        status = torch.empty(_lb_status_words(1, -(-m // _lb_tile(1))) // 2,
                             dtype=torch.int64, device=dev)
        _launch("fr_scan_lookback_launch", x.data_ptr(), m,
                ctypes.addressof(iw), int(not reverse), int(exclusive),
                status.data_ptr(), 8 * status.numel(), out.data_ptr(),
                stream)
        return out
    off = 0 if exclusive else 1
    lo_bits, hi_n = _pow_split(n + off)
    lo = torch.empty((1 << lo_bits, 4), dtype=torch.int64, device=dev)
    hi = torch.empty((hi_n, 4), dtype=torch.int64, device=dev)
    _launch("fr_pow_tables_launch", x.data_ptr(), ctypes.addressof(iw),
            lo_bits, hi_n, lo.data_ptr(), hi.data_ptr(), stream)
    out = torch.empty((n, 4), dtype=torch.int64, device=dev)
    _launch("fr_pow_values_launch", lo.data_ptr(), hi.data_ptr(), lo_bits,
            off, n, out.data_ptr(), stream)
    return out


def _lb_shape(k: int):
    """(steps of a chain a thread, threads a chain) of the look-back
    kernel at k <= LIN_MAX_K (csrc/fr_poly.cu's Lb): its tile holds that
    many steps of each of the k chains."""
    fits = LB_THREADS % k == 0 and LB_THREADS // k >= 16
    return LB_STEPS, LB_THREADS // k if fits else 32


def _lb_tile(k: int) -> int:
    """Values a look-back tile holds."""
    steps, threads = _lb_shape(k)
    return k * steps * threads


def _lb_status_words(k: int, tiles: int) -> int:
    """32-bit words of the look-back's status scratch: the ticket (padded
    to 4), a flag a tile (padded to 4), each tile's k aggregates and k
    inclusive prefixes."""
    return 4 + (tiles + 3) // 4 * 4 + 16 * k * tiles


def _lb_powers(k: int, c: int) -> list:
    """The look-back's LbPowers, Montgomery form: c, c^i for i < S, c^(S j)
    for j < 32, c^(GL S j) for j <= LB_THREADS / 32, c^(TS d) for d <=
    LB_WINDOW (S a thread's steps, GL the lanes of a chain's group, TS a
    tile's steps of a chain)."""
    steps, threads = _lb_shape(k)
    lanes = min(32, threads)

    def powers(base, count):
        out, cur = [], 1
        for _ in range(count):
            out.append(_mont(cur))
            cur = cur * base % R
        return out
    return ([_mont(c)] + powers(c, steps) + powers(pow(c, steps, R), 32)
            + powers(pow(c, lanes * steps, R), LB_THREADS // 32 + 1)
            + powers(pow(c, steps * threads, R), LB_WINDOW + 1))


def div_binomial(p: torch.Tensor, k: int, c: int, exact: bool = False):
    """(q, r) with p = q (X^k - c) + r for (n, 4) coefficient words: q of
    max(1, n - k) values, r of k.  With `exact`, raises AssertionError
    unless r = 0 (as the JAX package asserts its exact divisions).
    Wrapper of the ``fr_div_binomial`` kernels: a CPU tensor takes the
    plain version."""
    _check("div_binomial", p)
    if k < 1:
        raise ValueError("div_binomial: k >= 1 expected")
    c = int(c) % R
    if p.device.type == "cpu":
        q, r = _div_binomial_plain(p, k, c)
    else:
        kernels.LAUNCHES["fr_div_binomial"] += 1
        q, r = _div_binomial_launch(p, k, c)
    if exact and bool((r != 0).any()):
        raise AssertionError(f"division by X^{k} - c not exact")
    return q, r


def _div_binomial_launch(p: torch.Tensor, k: int, c: int):
    """k <= LIN_MAX_K: one look-back launch over u = p[k:] (its status
    words zeroed by the launcher), r on the host from q's and p's first k
    values; else one div_chain launch, r on the card."""
    n, dev = p.shape[0], p.device
    m = n - k
    stream = kernels.stream_ptr(dev)
    one = int(c == 1)
    if k <= LIN_MAX_K:
        if m > 0:
            q = torch.empty((m, 4), dtype=torch.int64, device=dev)
            tiles = -(-m // _lb_tile(k))
            status = torch.empty(_lb_status_words(k, tiles) // 2,
                                 dtype=torch.int64, device=dev)
            pw = _words_arg(_lb_powers(k, c))        # alive for the call
            _launch("fr_div_lookback_launch", p[k:].data_ptr(), m, k, one,
                    ctypes.addressof(pw), status.data_ptr(),
                    8 * status.numel(), q.data_ptr(), stream)
        else:
            q = torch.zeros((1, 4), dtype=torch.int64, device=dev)
        lo = from_words(p[:min(k, n)]) + [0] * max(0, k - n)
        qk = from_words(q[:min(k, m)]) if m > 0 else []
        qk += [0] * (k - len(qk))
        r = torch.from_numpy(to_words((a + c * b) % R for a, b in zip(lo, qk))
                             ).to(dev)
        return q, r
    q = (torch.empty if m > 0 else torch.zeros)(
        (max(1, m), 4), dtype=torch.int64, device=dev)
    r = torch.empty((k, 4), dtype=torch.int64, device=dev)
    cw = _words_arg([_mont(c)])
    _launch("fr_div_chain_launch", p.data_ptr(), n, k, one,
            ctypes.addressof(cw), q.data_ptr(), r.data_ptr(), stream)
    return q, r


@functools.lru_cache(maxsize=8)
def _domain_tables(bits: int, w: int, device):
    """The fr_pointwise domain tables of w^i, i < 2^bits: 2^lo canonical
    low powers and the high powers w^(2^lo h) in Montgomery form."""
    lo_bits = min(bits, DOMAIN_LO_BITS)
    lo = _domain_model(1 << lo_bits, w)
    hi = [_mont(v) for v in _domain_model(1 << (bits - lo_bits),
                                          pow(w, 1 << lo_bits, R))]
    return (torch.from_numpy(to_words(lo)).to(device),
            torch.from_numpy(to_words(hi)).to(device), lo_bits)


def pointwise(op: str, inputs, consts=(), w: int = 1, shift: int = 0):
    """The identity `op` (PW_OPS) over (n, 4) word inputs.  ``consts``
    (Python ints): lincomb the k_j; mul k; perm_z / perm_t2 beta, gamma.
    The perm identities read the domain point w^i (w of order n, the
    inputs' length) and perm_t2 z(w' x) as z at i + shift.  -> (n, 4)
    words (lincomb: n the longest input; perm_z: (numerator,
    denominator)).  Wrapper of the ``fr_pointwise`` kernel: CPU tensors
    take the plain version."""
    if op not in PW_OPS:
        raise ValueError(f"pointwise: unknown identity {op!r}")
    want = {"mul": 2, "gate": 9, "perm_z": 6, "perm_t2": 7}.get(op)
    if (want is not None and len(inputs) != want) or not inputs \
            or len(inputs) > PW_INPUTS:
        raise ValueError(f"pointwise {op}: {len(inputs)} inputs")
    _check(f"pointwise {op}", *inputs)
    n = max(x.shape[0] for x in inputs)
    if op != "lincomb" and any(x.shape[0] != n for x in inputs):
        raise ValueError(f"pointwise {op}: inputs of different lengths")
    consts = [int(k) % R for k in consts]
    if op in ("perm_z", "perm_t2") and (n & (n - 1) or pow(w, n, R) != 1):
        raise ValueError("pointwise: the domain's order must be the "
                         "inputs' length, a power of two")
    if inputs[0].device.type == "cpu":
        return _pointwise_plain(op, inputs, consts, w, shift)
    if n == 0:
        out = inputs[0].new_empty((0, 4))
        return (out, out.clone()) if op == "perm_z" else out
    kernels.LAUNCHES["fr_pointwise"] += 1
    return _pointwise_launch(op, inputs, consts, w, shift, n)


def _pointwise_consts(op: str, consts: list) -> list:
    """The kernel's constants of identity `op` (csrc/fr_poly.cu's
    pointwise), from the wrapper's: the lincomb's k_j and beta Montgomery
    form, the mul's k times 2^512, gamma canonical, and the fix of each
    identity's Montgomery form: 2^768 for the gate's and perm_z's
    (G' / R^2, num / R^2), 2^1024 for perm_t2's (.. / R^3)."""
    if op == "lincomb":
        return [_mont(k) for k in consts]
    if op == "mul":
        return [consts[0] * MONT * MONT % R]
    if op == "gate":
        return [pow(MONT, 3, R)]
    beta, gamma = consts
    return [_mont(beta), gamma, pow(MONT, 3 if op == "perm_z" else 4, R)]


def _pointwise_launch(op: str, inputs, consts: list, w: int, shift: int,
                      n: int):
    dev = inputs[0].device
    out = torch.empty((n, 4), dtype=torch.int64, device=dev)
    out2 = torch.empty_like(out) if op == "perm_z" else None
    ks = _pointwise_consts(op, consts)
    lo = hi = None
    lo_bits = 0
    if op in ("perm_z", "perm_t2"):
        bits = n.bit_length() - 1
        lo, hi, lo_bits = _domain_tables(bits, w % R, dev)
    ins = (ctypes.c_int64 * len(inputs))(*[x.data_ptr() for x in inputs])
    lens = (ctypes.c_int64 * len(inputs))(*[x.shape[0] for x in inputs])
    kw = _words_arg(ks) if ks else None
    _launch("fr_pointwise_launch", PW_OPS[op], ctypes.addressof(ins),
            ctypes.addressof(lens), len(inputs),
            None if kw is None else ctypes.addressof(kw), len(ks),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), lo_bits, shift % n,
            out.data_ptr(), None if out2 is None else out2.data_ptr(), n,
            kernels.stream_ptr(dev))
    return (out, out2) if op == "perm_z" else out
