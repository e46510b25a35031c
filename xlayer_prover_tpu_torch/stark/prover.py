"""STARK prover: the 5-round pipeline + FRI on one device.

Counterpart of the single-device accelerator branch of
``xlayer_prover_tpu/stark/prover.py`` (parity with Starks::genProof,
starks.cpp:9-404):

  round 1  LDE + Merkle of cm1                       -> root1
  round 2  draw u,defVal; plookup h1/h2 (cm2)        -> root2
  round 3  draw gamma,beta; grand products Z (cm3)   -> root3
  round 4  draw vc; quotient on ext domain, split    -> root4 (cm4)
  round 5  draw xi; evals via INTT-weighted inner products; draw v1,v2;
           DEEP/FRI polynomial; FRI fold/commit/query phases.

Sections are (rows, cols) int64 tensors; the round functions are plain
PyTorch over them (every Goldilocks product through the ``gl_mul``
kernel, every hash through ``poseidon_linear_hash`` on a GPU).  The host
handles the transcript scalars, the plookup missing-value count and the
proof assembly.

The layout follows ``stark_info.memory_plan`` at the device's memory (or
the budget the Setup was built under, ``hbm_bytes``), as the JAX host
pipeline does
(``xlayer_prover_tpu/stark/prover.py:815-830``):

  * resident: every section on the device;
  * stream: the extended sections (const, cm1..cm4) in page-locked host
    memory, each extended and hashed on the device a column block at a
    time (``GLScheme.extend_and_commit``); the natural-domain sections of
    rounds 2-3 stay on the device; the quotient, round 5's evaluations
    and the FRI polynomial are computed over windows of rows of the
    extended domain uploaded with their halo; FRI opens the query rows
    from the host sections.  The trees stay on the device.

In both layouts the quotient and round 5 run over row windows sized from
what the budget leaves (``window_rows``).  Where a window covers the
domain and the sections lie on the device, the quotient evaluates whole
columns and round 5 takes the ev_map an entry at a time, as before the
plan.  The proof is the same bytes in every layout and window size.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import device as dev
from ..fields import gl, gl3
from ..ops import merkle, ntt
from ..ops.ntt import _np_modmul, _np_pow_table
from ..ops.poseidon_gl import RATE
from . import air as air_mod
from . import fri as fri_mod
from . import lookup
from .air import CH_BETA, CH_DEFVAL, CH_GAMMA, CH_U, CH_V1, CH_V2, CH_VC, CH_XI
from .commitment import get_scheme
from .eval import EvalEnv, count_refs, halo_rows
from .proof import StarkProof
from .stark_info import info_from_air, memory_plan

P = gl.P

# The LDE's column block in a streamed plan: the plan's stream_block_cols,
# clamped to [8, 64] as the JAX host pipeline clamps it (prover.py:827)
# and rounded down to a multiple of RATE, so that each block's leaf
# digests carry into the next block's.  The port's extend_pol holds ~5
# copies of a block at once; at the plan's own width (680 columns at 2^18
# under 16 GiB) that alone would pass the budget.
STREAM_BLOCK_MAX = 64

# Working memory of the quotient's evaluation, per byte of a row of the
# extended sections, over whole columns (the rolled copies of the shifted
# columns, kept for the env) and over a window (its live frontier under
# count_refs and the products' temporaries; the window's upload is counted
# apart).  Calibrated on an H100 80GB HBM3 (700 W) with devnet batch 0 at
# 2^18 with the chains, 21,080 B a row of sections (2,635 columns), by
# gen_proof's stats["quotient_bytes"] (device bytes allocated after each
# constraint, less those at the quotient's start) in chip_smoke.py's
# phase 10 and phase 12 (b): over whole columns (one window of 524,288
# rows) 8,313,179,648 B, 15,856 B a row, 0.75 of a row of sections; over
# 4 windows of 131,072 rows 2,913,191,424 B, of which the window's upload
# (131,074 rows of 2,629 columns) 2,756,748,368 B, so 1,194 B a row of
# evaluation, 0.057.  The factors leave room for the temporaries within
# one constraint, which sampling between constraints does not see.
EVAL_WHOLE_BYTES_PER_SECTION_BYTE = 0.8
EVAL_WINDOW_BYTES_PER_SECTION_BYTE = 0.25
# The share of the budget the windows may fill, the plan's own residency
# threshold (memory_plan: resident when the sections fit 0.75 of it).
BUDGET_SHARE = 0.75
# Round 5 over windows, or over sections in host memory, takes the
# ev_map's columns this many at a time (one section, shift and
# dimension): a few launches a chunk, where an entry at a time would
# repeat tens of launches an entry in every window.
EV_CHUNK = 64


class LookupMissingError(ValueError):
    """A plookup's f holds values that its table t lacks."""


class ProofCancelled(Exception):
    """Raised between rounds when an abort_check callback fires (the
    cooperative mid-proof cancellation the reference lacks — its
    cancel only skips queued jobs, prover.cpp:300-349)."""


@dataclasses.dataclass(frozen=True)
class SectionPlan:
    """How a proof lays its sections out: ``memory_plan``'s dict for the
    budget (device bytes), whether the extended sections stream through
    host memory, and the LDE's column block when they do."""
    budget: int
    stream: bool
    block_cols: int
    plan: dict


def section_plan(air, device, hbm_bytes=None) -> SectionPlan:
    """``memory_plan(info_from_air(air), 1, hbm_bytes)``; `hbm_bytes`
    None means the device's memory (a CPU device: the plan's default,
    16 GiB).  A BN128 AIR cannot stream (its trees are built from
    device-resident sections, as in the JAX package): ValueError."""
    device = torch.device(device)
    if hbm_bytes is None:
        hbm_bytes = (torch.cuda.get_device_properties(device).total_memory
                     if device.type == "cuda" else 16 << 30)
    plan = memory_plan(info_from_air(air), n_devices=1,
                       hbm_bytes=int(hbm_bytes))
    stream = not plan["hbm_resident"]
    if stream and get_scheme(air).name != "gl":
        raise ValueError(
            f"the {get_scheme(air).name} commitment scheme does not stream "
            f"its sections (ROADMAP 12b, memory_plan streaming): "
            f"{plan['total_bytes']} bytes of sections pass 0.75 of the "
            f"{int(hbm_bytes)}-byte budget")
    block = 0
    if stream:
        block = max(RATE, min(plan["stream_block_cols"], STREAM_BLOCK_MAX))
        block -= block % RATE
    return SectionPlan(budget=int(hbm_bytes), stream=stream,
                       block_cols=block, plan=plan)


def window_rows(air, sp: SectionPlan) -> tuple[int, int]:
    """Rows of the extended domain a window holds, for the quotient and
    for round 5: powers of two, at least the blowup (round 5 samples
    every blowup-th row) and at most the domain.  What the budget's share
    leaves after the data that stays on the device (resident sections,
    the constants on the natural domain, the trees, the domain columns
    and accumulators), over the bytes a row needs.  The quotient's
    window holds every section with its halo (uploaded, in a streamed
    plan) and the evaluation's working memory; round 5's one section at
    a time and a chunk's temporaries."""
    n_ext = air.n_ext
    widths = (air.const_width, air.cm1_width, air.cm2_width,
              air.cm3_width, air.cm4_width)
    row_bytes = 8 * sum(widths)
    # x, l1, zi, the quotient's (n_ext, 3) and the FRI polynomial's
    # 3 columns, five trees of 2 n_ext digests, the natural-domain
    # constants
    kept = n_ext * 8 * (3 + 3 + 3 + 5 * 2 * 4) + air.n * 8 * air.const_width
    round5_row = 8 * (16 * EV_CHUNK + 64)
    if sp.stream:
        quotient_row = row_bytes * (1 + EVAL_WINDOW_BYTES_PER_SECTION_BYTE)
        round5_row += 8 * max(widths)
    else:
        quotient_row = row_bytes * EVAL_WHOLE_BYTES_PER_SECTION_BYTE
        kept += n_ext * row_bytes
    room = int(sp.budget * BUDGET_SHARE) - kept

    def fit(per_row):
        rows = n_ext
        while rows > n_ext // air.n and rows * per_row > room:
            rows //= 2
        return rows

    return fit(quotient_row), fit(round5_row)


def _rows_on(sec, r0: int, count: int, device):
    """Rows [r0, r0 + count) of a section, mod its height, as a tensor on
    `device`: a view where the section lies there and the rows do not
    wrap, else a copy (two pieces where they wrap; from host memory, one
    DMA each)."""
    n = sec.shape[0]
    end = r0 + count
    if sec.device.type == device.type and end <= n:
        return sec[r0:end]
    out = torch.empty((count, sec.shape[1]), dtype=sec.dtype, device=device)
    first = min(end, n) - r0
    dev.copy(out[:first], sec[r0:r0 + first])
    if end > n:
        dev.copy(out[first:], sec[:end - n])
    return out


def _to_host(t, device):
    """A device tensor moved into a host section (page-locked beside a
    GPU)."""
    out = dev.host_empty(tuple(t.shape), device)
    dev.copy(out, t)
    return out


@dataclasses.dataclass
class Setup:
    """Preprocessed data: constant polynomials, their LDE and tree (verkey).

    `const_ext` lies on the device, or in host memory where the plan for
    the budget the Setup was built under (`hbm_bytes`) streams."""
    air: object
    const_n: torch.Tensor
    const_ext: torch.Tensor
    const_tree: object
    verkey: list
    device: torch.device
    hbm_bytes: int | None = None

    @staticmethod
    def build(air, const_np: np.ndarray, device=None,
              hbm_bytes=None) -> "Setup":
        """Constant LDE + tree on `device` (None: the GPU), laid out by
        ``section_plan(air, device, hbm_bytes)``."""
        device = dev.resolve(device)
        if const_np.shape != (air.n, air.const_width):
            raise ValueError(f"const_np shape {const_np.shape} != "
                             f"{(air.n, air.const_width)}")
        scheme = get_scheme(air)
        sp = section_plan(air, device, hbm_bytes)
        const_n = gl.from_u64_np(const_np.astype(np.uint64), device)
        const_ext, tree = _extend_commit(scheme, sp, const_n, air, device)
        return Setup(air=air, const_n=const_n, const_ext=const_ext,
                     const_tree=tree, verkey=scheme.root(tree), device=device,
                     hbm_bytes=hbm_bytes)

    def save(self, path: str):
        """Persist the preprocessed const artifacts (the reference's
        zkevmConstantsTree/bctree file slot, config.hpp:132-136): const
        pols, their LDE, every tree level and the verkey in one npz, the
        JAX package's layout (pulled from the device to the host)."""
        levels = {f"level{i}": gl.to_u64_np(lv)
                  for i, lv in enumerate(self.const_tree.levels)}
        np.savez_compressed(
            path, const_n=gl.to_u64_np(self.const_n),
            const_ext=gl.to_u64_np(self.const_ext),
            verkey=np.array(self.verkey, dtype=np.uint64),
            n_levels=np.int64(len(self.const_tree.levels)), **levels)

    @staticmethod
    def load(path: str, air, device=None, hbm_bytes=None) -> "Setup":
        """Load a ``save`` artifact (the port's or the JAX package's) onto
        `device` (None: the GPU), `const_ext` into host memory where the
        plan for `hbm_bytes` streams; shape-checked against the air.  The
        artifact holds a GL tree, as in the JAX package."""
        device = dev.resolve(device)
        if get_scheme(air).name != "gl":
            raise ValueError("constants artifacts hold GL Merkle trees")
        sp = section_plan(air, device, hbm_bytes)
        with np.load(path) as z:
            const_n_np = z["const_n"]
            if const_n_np.shape != (air.n, air.const_width):
                raise ValueError("constants artifact does not match this "
                                 "air geometry")
            levels = [gl.from_u64_np(z[f"level{i}"], device)
                      for i in range(int(z["n_levels"]))]
            if sp.stream:
                ext_np = z["const_ext"]
                const_ext = dev.host_empty(ext_np.shape, device)
                const_ext.copy_(torch.from_numpy(
                    np.ascontiguousarray(ext_np).view(np.int64)))
            else:
                const_ext = gl.from_u64_np(z["const_ext"], device)
            verkey = [int(v) for v in z["verkey"]]
        tree = merkle.MerkleTree(levels=tuple(levels), width=air.const_width)
        return Setup(air=air, const_n=gl.from_u64_np(const_n_np, device),
                     const_ext=const_ext, const_tree=tree, verkey=verkey,
                     device=device, hbm_bytes=hbm_bytes)


def _extend_commit(scheme, sp: SectionPlan, section_n, air, device):
    """A section's LDE and its tree: on the device (resident), or the LDE
    in host memory, streamed a column block at a time."""
    width = section_n.shape[1]
    if sp.stream:
        return scheme.extend_and_commit(section_n, air.n_bits_ext,
                                        sp.block_cols, device)
    if width:
        ext = ntt.extend_pol(section_n, air.n_bits_ext)
    else:
        ext = gl.zeros((air.n_ext, 0), device)
    return ext, scheme.merkelize(ext, width)


def _domain_x(n_bits: int, device, shift: int = 1):
    return gl.powers_device(gl.host_w(n_bits), 1 << n_bits, device,
                            start=shift)


def _l1_values_n(n: int, device):
    v = gl.zeros((n,), device)
    v[0] = 1
    return v


def _l1_values_ext(air, device):
    """L1 on the ext coset: (x^N - 1) / (N (x - 1)), exact (numpy power
    tables + a device batch inverse)."""
    n, n_ext = air.n, air.n_ext
    w_ext = gl.host_w(air.n_bits_ext)
    inv_n = gl.host_inv(n)
    xs = _np_modmul(_np_pow_table(w_ext, n_ext), np.uint64(gl.SHIFT % P))
    wn = pow(w_ext, n, P)
    xn = _np_modmul(_np_pow_table(wn, n_ext), np.uint64(pow(gl.SHIFT, n, P)))
    one = np.uint64(1)
    pm1 = np.uint64(P - 1)
    num = np.where(xn >= one, xn - one, pm1)
    den = np.where(xs >= one, xs - one, pm1)
    inv_den = gl.batch_inv(gl.from_u64_np(den, device))
    return gl.mul_const(gl.mul(gl.from_u64_np(num, device), inv_den), inv_n)


def _zi_values_ext(air, device):
    """1/(x^N - 1) on the ext coset; only blowup distinct values, tiled."""
    blowup = air.n_ext // air.n
    wn = pow(gl.host_w(air.n_bits_ext), air.n, P)
    cur = pow(gl.SHIFT, air.n, P)
    distinct = []
    for _ in range(blowup):
        distinct.append(pow((cur - 1) % P, P - 2, P))
        cur = (cur * wn) % P
    return gl.from_u64_np(np.tile(np.array(distinct, dtype=np.uint64), air.n),
                          device)


def _exclusive_prefix_product(ratios):
    """gl3 triple (N,) -> Z with Z[0] = 1, Z[i] = prod_{j<i} ratios[j]
    (a log-step scan over gl3.mul: torch.cumprod wraps mod 2^64)."""
    pre = gl3.scan_mul(ratios)
    one = gl3.ones((1,), ratios[0].device)
    return tuple(torch.cat([o, c[:-1]]) for o, c in zip(one, pre))


def _challenges_array(challenges: dict, device):
    """dict slot -> [3 ints]  =>  (8, 3) int64 device tensor, one upload."""
    arr = np.zeros((air_mod.NUM_CHALLENGES, 3), dtype=np.uint64)
    for s, tri in challenges.items():
        arr[s] = [int(c) % P for c in tri]
    return gl.from_u64_np(arr, device)


def _challenges_env(ch):
    """(8, 3) tensor -> EvalEnv challenges dict of 0-d views."""
    return {s: tuple(ch[s, k] for k in range(3)) for s in range(ch.shape[0])}


def _pubs(air, publics):
    return [publics[i] for i in range(air.n_publics)]


def _broad3(triple, n: int):
    return tuple(c.expand(n) for c in triple)


def _set_cols(section, start: int, triple):
    """Write a gl3 triple of (N,) tensors into columns [start:start+3]."""
    for k in range(3):
        section[:, start + k] = triple[k]


# ---------------------------------------------------------------------------
# Round functions
# ---------------------------------------------------------------------------

def round2(air, const_n, cm1_n, ch, publics, x_n, l1_n):
    """Plookup h1/h2 -> (cm2_n, bad): bad (0-d) counts f values missing
    from t over all plookups."""
    n = air.n
    cm2 = gl.zeros((n, air.cm2_width), x_n.device)
    bad_total = gl.zeros((), x_n.device)
    for pu in air.plookups:
        env = EvalEnv({"const": const_n, "cm1": cm1_n}, _challenges_env(ch),
                      _pubs(air, publics), x_n, l1_n, 1)
        f = torch.stack(_broad3(env.eval_ext(pu.f_exp), n), dim=1)
        t = torch.stack(_broad3(env.eval_ext(pu.t_exp), n), dim=1)
        h1, h2, bad = lookup.calculate_h1h2_device(f, t)
        cm2[:, pu.h1_col.index:pu.h1_col.index + 3] = h1
        cm2[:, pu.h2_col.index:pu.h2_col.index + 3] = h2
        bad_total = bad_total + bad
    return cm2, bad_total


def _numden_jobs(air):
    """(z_col, num_expr, den_expr) per grand product, and the connections
    whose products are split into committed im columns."""
    gamma = air_mod.Challenge(CH_GAMMA)
    beta = air_mod.Challenge(CH_BETA)
    one_plus_beta = beta + 1
    gb = gamma * one_plus_beta
    jobs = []
    conn_jobs = []
    for pu in air.plookups:
        f, t = pu.f_exp, pu.t_exp
        h1c, h2c = pu.h1_col, pu.h2_col
        num = one_plus_beta * (gamma + f) \
            * (gb + t + beta * air_mod._shift_expr(t))
        den = (gb + h1c + beta * h2c) * (gb + h2c + beta * h1c.shifted())
        jobs.append((pu.z_col, num, den))
    for pe in air.permutations:
        jobs.append((pe.z_col, pe.f_exp + gamma, pe.t_exp + gamma))
    for ci in air.connections:
        xx = air_mod.XSymbol()
        num_factors = [c + beta * k * xx + gamma
                       for c, k in zip(ci.cols, ci.k_coeffs)]
        den_factors = [c + beta * s + gamma
                       for c, s in zip(ci.cols, ci.s_cols)]
        if not ci.num_ims:
            num = air_mod.Const(1)
            den = air_mod.Const(1)
            for fn_, fd in zip(num_factors, den_factors):
                num = num * fn_
                den = den * fd
            jobs.append((ci.z_col, num, den))
        else:
            conn_jobs.append((ci, num_factors, den_factors))
    return jobs, conn_jobs


def _zscan(num_v, den_v):
    return _exclusive_prefix_product(gl3.mul(num_v, gl3.batch_inv(den_v)))


def round3(air, const_n, cm1_n, cm2_n, ch, publics, x_n, l1_n):
    """Grand products Z and the committed im columns -> cm3_n."""
    n = air.n

    def env():
        return EvalEnv({"const": const_n, "cm1": cm1_n, "cm2": cm2_n},
                       _challenges_env(ch), _pubs(air, publics), x_n, l1_n, 1)

    cm3 = gl.zeros((n, air.cm3_width), x_n.device)
    jobs, conn_jobs = _numden_jobs(air)
    for zcol, num_e, den_e in jobs:
        e = env()
        _set_cols(cm3, zcol.index, _zscan(_broad3(e.eval_ext(num_e), n),
                                          _broad3(e.eval_ext(den_e), n)))
    for col, expr in air.im_defs:
        k, v = env().eval(expr)
        _set_cols(cm3, col.index,
                  _broad3(gl3.from_base(v) if k == "base" else v, n))
    for ci, num_factors, den_factors in conn_jobs:
        e = env()
        groups = ci.factor_groups()
        finals = []
        for ims, factors in ((ci.num_ims, num_factors),
                             (ci.den_ims, den_factors)):
            vals = [e.eval_ext(f_) for f_ in factors]
            prod = None
            for gi, grp in enumerate(groups):
                for fi in grp:
                    prod = vals[fi] if prod is None else gl3.mul(prod, vals[fi])
                _set_cols(cm3, ims[gi].index, _broad3(prod, n))
            finals.append(_broad3(prod, n))
        _set_cols(cm3, ci.z_col.index, _zscan(finals[0], finals[1]))
    return cm3


def quotient(air, sections_ext, ch, publics, x_ext, l1_ext, zi_ext,
             rows: int | None = None, mem: dict | None = None):
    """Constraints combined by powers of vc, divided by Z_H, split into
    q_deg chunks of degree < N and extended -> cm4_ext (n_ext, q_deg*3)
    on the device.

    sections_ext: name -> (n_ext, width) section, on the device or in
    host memory.  rows: the window (a power of two dividing n_ext; None,
    the domain): each window's sections are uploaded with their halo and
    its constraints accumulated into the (n_ext, 3) quotient values; one
    window over the domain evaluates whole columns.  The INTT/NTT of the
    quotient stay global.  mem: if a dict is given (a GPU), the device
    bytes allocated at the start ("base") and the most allocated after
    any constraint of any window ("peak")."""
    n, n_ext = air.n, air.n_ext
    device = x_ext.device
    blowup = n_ext // n
    rows = n_ext if rows is None else rows
    constraints = air_mod.all_constraints(air)
    refcounts = count_refs(constraints)
    halo = halo_rows(constraints, blowup)
    vc = tuple(ch[CH_VC, k] for k in range(3))
    whole = rows == n_ext and all(sec.device.type == device.type
                                  for sec in sections_ext.values())
    q_vals = None if rows == n_ext else gl.zeros((n_ext, 3), device)
    sample = mem is not None and device.type == "cuda"
    if sample:
        mem["base"] = mem["peak"] = torch.cuda.memory_allocated(device)
    for r0 in range(0, n_ext, rows):
        if whole:
            env = EvalEnv(sections_ext, _challenges_env(ch),
                          _pubs(air, publics), x_ext, l1_ext, blowup,
                          refcounts=refcounts)
        else:
            env = EvalEnv({name: _rows_on(sec, r0, rows + halo, device)
                           for name, sec in sections_ext.items()},
                          _challenges_env(ch), _pubs(air, publics),
                          x_ext[r0:r0 + rows], l1_ext[r0:r0 + rows], blowup,
                          refcounts=refcounts, window=rows)
        acc = None
        for c in constraints:
            val = env.eval_ext(c)
            acc = val if acc is None else gl3.add(gl3.mul(acc, vc), val)
            if sample:
                mem["peak"] = max(mem["peak"],
                                  torch.cuda.memory_allocated(device))
        q = gl3.stack_cols(tuple(gl.mul(c, zi_ext[r0:r0 + rows])
                                 for c in _broad3(acc, rows)))
        del env, acc
        if q_vals is None:
            q_vals = q
        else:
            q_vals[r0:r0 + rows] = q
        del q
    q_coeffs = ntt.intt(q_vals, air.n_bits_ext)
    shift_in = pow(gl.host_inv(gl.SHIFT), n, P)
    parts = []
    cur_s = 1
    for p_i in range(air.q_deg):
        chunk = gl.mul_const(q_coeffs[p_i * n:(p_i + 1) * n], cur_s)
        cur_s = (cur_s * shift_in) % P
        chunk = torch.cat([chunk, gl.zeros((n_ext - n, 3), device)])
        parts.append(ntt.ntt(chunk, air.n_bits_ext))
    return torch.cat(parts, dim=1)


def _lagrange_weights(point3, n_bits: int):
    """INTT of the geometric series [point^k]_{k<N} (reference LEv/LpEv)."""
    series = gl3.powers_device(point3, 1 << n_bits)
    return gl3.from_cols(ntt.intt(gl3.stack_cols(series), n_bits))


def _x_div_x_sub(x_ext, point3):
    """x / (x - point) over the extended domain (batch-inverted)."""
    diff = gl3.sub(gl3.from_base(x_ext), point3)
    return gl3.mul_base(gl3.batch_inv(diff), x_ext)


def _ev_groups(air) -> dict:
    """The ev_map's entries by section, then by (shift, dim), each
    group's (entry number, column) pairs cut into chunks of EV_CHUNK:
    round 5 works a chunk of columns at a time."""
    groups: dict = {}
    for j, e in enumerate(air.ev_map):
        groups.setdefault(e.section, {}).setdefault(
            (e.shift, e.dim), []).append((j, e.index))
    return {name: {key: [items[i:i + EV_CHUNK]
                         for i in range(0, len(items), EV_CHUNK)]
                   for key, items in by_key.items()}
            for name, by_key in groups.items()}


def _chunk_cols(sec, chunk, dim: int, device):
    """(entry numbers, columns) of a chunk: the entries' columns of `sec`
    as (rows, k) tensors, one (base) or three (extension)."""
    js = torch.tensor([j for j, _ in chunk], dtype=torch.int64,
                      device=device)
    idx = torch.tensor([i for _, i in chunk], dtype=torch.int64,
                       device=device)
    return js, tuple(sec.index_select(1, idx + k) for k in range(dim))


def round5(air, sections_ext, ch, x_ext, phase: str, evals_arr=None,
           rows: int | None = None):
    """phase "evals": (n_ev, 3) evaluations at the shifted xi points,
    sum_i L_s(i) * column(i) over every blowup-th row of the extended
    domain.  phase "fri": the DEEP/FRI polynomial (gl3 triple over the
    ext domain) from `evals_arr`: sum over shifts s of v2^s x / (x - xi
    w^s) sum_j (column_j - ev_j) v1^j.

    One window over the domain (`rows` None or n_ext) with every section
    on the device, as in a resident plan, takes the ev_map an entry at a
    time.  Windows of `rows` rows, or sections in host memory, take its
    columns EV_CHUNK at a time (``_round5_windows``)."""
    if phase not in ("evals", "fri"):
        raise ValueError(f"round5: unknown phase {phase!r}")
    device = x_ext.device
    if (rows is None or rows == air.n_ext) and all(
            sec.device.type == device.type for sec in sections_ext.values()):
        return _round5_entries(air, sections_ext, ch, x_ext, phase,
                               evals_arr)
    return _round5_windows(air, sections_ext, ch, x_ext, phase, evals_arr,
                           air.n_ext if rows is None else rows)


def _ev_weights(air, ch, device) -> dict:
    """shift -> the Lagrange weights (n rows, gl3) of the point xi w^s."""
    w_n = gl.host_w(air.n_bits)
    xi = tuple(ch[CH_XI, k] for k in range(3))
    shift_inv = gl.host_inv(gl.SHIFT)
    return {s_: _lagrange_weights(gl3.mul_base(xi, dev.scalar(
        (pow(w_n, s_, P) * shift_inv) % P, device)), air.n_bits)
        for s_ in sorted({e.shift for e in air.ev_map})}


def _round5_entries(air, sections_ext, ch, x_ext, phase, evals_arr):
    """round5 over the whole domain on the device, an ev_map entry at a
    time."""
    n_ext = air.n_ext
    blowup = n_ext // air.n
    device = x_ext.device
    shifts = sorted({e.shift for e in air.ev_map})
    w_n = gl.host_w(air.n_bits)
    xi = tuple(ch[CH_XI, k] for k in range(3))
    if phase == "evals":
        weights = _ev_weights(air, ch, device)
        evals = []
        for entry in air.ev_map:
            samp = sections_ext[entry.section][::blowup]
            w3 = weights[entry.shift]
            if entry.dim == 1:
                col = samp[:, entry.index]
                prod = tuple(gl.mul(w, col) for w in w3)
            else:
                prod = gl3.mul(w3, tuple(samp[:, entry.index + k]
                                         for k in range(3)))
            evals.append(torch.stack(list(gl3.sum_axis(prod, axis=0))))
        return torch.stack(evals)
    v1 = tuple(ch[CH_V1, k] for k in range(3))
    v2 = tuple(ch[CH_V2, k] for k in range(3))
    v1_pow = gl3.ones((), device)
    accs = {s_: gl3.zeros((n_ext,), device) for s_ in shifts}
    for j, entry in enumerate(air.ev_map):
        sec = sections_ext[entry.section]
        if entry.dim == 1:
            colv = gl3.from_base(sec[:, entry.index])
        else:
            colv = tuple(sec[:, entry.index + k] for k in range(3))
        ev3 = tuple(evals_arr[j, k] for k in range(3))
        term = gl3.mul(gl3.sub(colv, ev3), v1_pow)
        accs[entry.shift] = gl3.add(accs[entry.shift], term)
        v1_pow = gl3.mul(v1_pow, v1)
    fri_pol = gl3.zeros((n_ext,), device)
    v2_pow = gl3.ones((), device)
    for s_ in shifts:
        pt = gl3.mul_base(xi, dev.scalar(pow(w_n, s_, P), device))
        xdiv = _x_div_x_sub(x_ext, pt)
        fri_pol = gl3.add(fri_pol,
                          gl3.mul(gl3.mul(accs[s_], xdiv), v2_pow))
        v2_pow = gl3.mul(v2_pow, v2)
    return fri_pol


def _round5_windows(air, sections_ext, ch, x_ext, phase, evals_arr,
                    rows: int):
    """round5 over windows of `rows` rows of the extended domain, one
    section of a window on the device at a time, the ev_map's columns
    EV_CHUNK at a time (a section, a shift and a dimension): an
    evaluation is the sum of its windows' partial sums (the Lagrange
    weights stay whole, n rows); the FRI polynomial is written window by
    window, its inner sum taken as sum_j column_j v1^j - sum_j ev_j v1^j."""
    n_ext = air.n_ext
    blowup = n_ext // air.n
    device = x_ext.device
    starts = range(0, n_ext, rows)
    groups = _ev_groups(air)
    shifts = sorted({e.shift for e in air.ev_map})
    if phase == "evals":
        weights = _ev_weights(air, ch, device)
        evals = gl.zeros((len(air.ev_map), 3), device)
        for r0 in starts:
            lo, hi = r0 // blowup, (r0 + rows) // blowup
            for name, by_key in groups.items():
                samp = _rows_on(sections_ext[name], r0, rows,
                                device)[::blowup]
                for (s_, dim), chunks in by_key.items():
                    w3 = tuple(w[lo:hi, None] for w in weights[s_])
                    for chunk in chunks:
                        js, cols = _chunk_cols(samp, chunk, dim, device)
                        prod = tuple(gl.mul(cols[0], w) for w in w3) \
                            if dim == 1 else gl3.mul(cols, w3)
                        part = gl3.stack_cols(gl3.sum_axis(prod, axis=0))
                        evals[js] = gl.add(evals[js], part)
                del samp
        return evals
    w_n = gl.host_w(air.n_bits)
    xi = tuple(ch[CH_XI, k] for k in range(3))
    v1 = tuple(ch[CH_V1, k] for k in range(3))
    v2 = tuple(ch[CH_V2, k] for k in range(3))
    v1_pows = gl3.powers_device(v1, len(air.ev_map))
    # sum_j ev_j v1^j over each shift's entries
    ev_sums = {}
    for s_ in shifts:
        js = torch.tensor([j for j, e in enumerate(air.ev_map)
                           if e.shift == s_], dtype=torch.int64,
                          device=device)
        ev3 = tuple(evals_arr[:, k].index_select(0, js) for k in range(3))
        ev_sums[s_] = gl3.sum_axis(gl3.mul(ev3, gl3.take(v1_pows, js)),
                                   axis=0)
    points, v2_pows = [], [gl3.ones((), device)]
    for s_ in shifts:
        points.append(gl3.mul_base(xi, dev.scalar(pow(w_n, s_, P), device)))
        v2_pows.append(gl3.mul(v2_pows[-1], v2))
    fri_pol = gl3.zeros((n_ext,), device)
    for r0 in starts:
        accs = {s_: gl3.zeros((rows,), device) for s_ in shifts}
        for name, by_key in groups.items():
            sec = _rows_on(sections_ext[name], r0, rows, device)
            for (s_, dim), chunks in by_key.items():
                for chunk in chunks:
                    js, cols = _chunk_cols(sec, chunk, dim, device)
                    vp = tuple(v.index_select(0, js)[None, :]
                               for v in v1_pows)
                    prod = tuple(gl.mul(cols[0], v) for v in vp) \
                        if dim == 1 else gl3.mul(cols, vp)
                    accs[s_] = gl3.add(accs[s_], gl3.sum_axis(prod, axis=1))
            del sec
        x_win = x_ext[r0:r0 + rows]
        win = gl3.zeros((rows,), device)
        for i, s_ in enumerate(shifts):
            acc = gl3.sub(accs[s_], ev_sums[s_])
            xdiv = _x_div_x_sub(x_win, points[i])
            win = gl3.add(win, gl3.mul(gl3.mul(acc, xdiv), v2_pows[i]))
        for k in range(3):
            fri_pol[k][r0:r0 + rows] = win[k]
    return fri_pol


def _round5_with(air, sections_ext, challenges, x_ext, phase,
                 evals_arr=None, rows=None):
    return round5(air, sections_ext, _challenges_array(challenges,
                                                       x_ext.device),
                  x_ext, phase, evals_arr, rows)


# ---------------------------------------------------------------------------
# The proof
# ---------------------------------------------------------------------------

def gen_proof(setup: Setup, cm1_np: np.ndarray, publics,
              timings: dict | None = None,
              abort_check=None,
              stats: dict | None = None) -> StarkProof:
    """Prove the trace `cm1_np` (n, cm1_width) uint64 on `setup.device`.

    timings: if a dict is given, the wall seconds of each round (keys
    step1..step5, fri) are written into it.  Each round ends by pulling
    its Merkle root (or the evals) to the host, which waits for the
    device, so the times are device times plus host work.

    abort_check: optional zero-arg callable polled at two round
    boundaries, before step 2 and before step 3; returning True raises
    ProofCancelled.

    The sections are laid out by the plan for the Setup's budget
    (``setup.hbm_bytes``; None: the device's memory), the one its
    const_ext was built under.

    stats: if a dict is given, the plan (its total bytes, resident or
    streamed, the column block), the row windows of the quotient and of
    round 5 and their numbers, the bytes and seconds of the host <->
    device copies and of page-locking the host sections (and the waits
    for it: their count and seconds) and, on a GPU, the quotient's base
    and peak bytes (``quotient``'s mem), and the device bytes allocated
    at the end of each round and the peak so far (the allocator's,
    cumulative) are written into it."""
    air = setup.air

    def _abort_point():
        if abort_check is not None and abort_check():
            raise ProofCancelled("proof aborted between rounds")

    device = setup.device
    n, n_ext = air.n, air.n_ext
    publics = [int(p) % P for p in publics]
    if len(publics) != air.n_publics:
        raise ValueError(f"{len(publics)} publics, expected {air.n_publics}")
    if cm1_np.shape != (n, air.cm1_width):
        raise ValueError(f"cm1_np shape {cm1_np.shape} != "
                         f"{(n, air.cm1_width)}")
    scheme = get_scheme(air)
    sp = section_plan(air, device, setup.hbm_bytes)
    rows, rows5 = window_rows(air, sp)
    peaks, allocated, qmem = {}, {}, {}
    if stats is not None:
        dev.reset_copies()
        stats.update(stream=sp.stream, budget=sp.budget,
                     total_bytes=sp.plan["total_bytes"],
                     hbm_resident=sp.plan["hbm_resident"],
                     stream_block_cols=sp.plan.get("stream_block_cols"),
                     block_cols=sp.block_cols, window_rows=rows,
                     windows=n_ext // rows, round5_window_rows=rows5,
                     round5_windows=n_ext // rows5, peak_bytes=peaks,
                     allocated_bytes=allocated, quotient_bytes=qmem)
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock[0]
        clock[0] = now
        if stats is not None and device.type == "cuda":
            peaks[name] = torch.cuda.max_memory_allocated(device)
            allocated[name] = torch.cuda.memory_allocated(device)

    transcript = scheme.transcript()
    transcript.put(setup.verkey)
    transcript.put(publics)

    x_n = _domain_x(air.n_bits, device)
    x_ext = _domain_x(air.n_bits_ext, device, shift=gl.SHIFT)
    l1_n = _l1_values_n(n, device)
    l1_ext = _l1_values_ext(air, device)
    zi_ext = _zi_values_ext(air, device)
    publics_arr = gl.from_u64_np(np.array(publics + [0], dtype=np.uint64),
                                 device)
    challenges = {}

    # ---- round 1: cm1 -------------------------------------------------
    cm1_n = gl.from_u64_np(cm1_np.astype(np.uint64), device)
    cm1_ext, tree1 = _extend_commit(scheme, sp, cm1_n, air, device)
    root1 = scheme.root(tree1)
    transcript.put(root1)
    lap("step1")

    # ---- round 2: plookup h1/h2 ---------------------------------------
    challenges[CH_U] = transcript.get_field()
    challenges[CH_DEFVAL] = transcript.get_field()
    _abort_point()
    cm2_n, bad_total = round2(air, setup.const_n, cm1_n,
                              _challenges_array(challenges, device),
                              publics_arr, x_n, l1_n)
    if air.plookups and int(bad_total) != 0:
        raise LookupMissingError("plookup: f contains values missing from t")
    cm2_ext, tree2 = _extend_commit(scheme, sp, cm2_n, air, device)
    root2 = scheme.root(tree2)
    transcript.put(root2)
    lap("step2")

    # ---- round 3: grand products Z ------------------------------------
    challenges[CH_GAMMA] = transcript.get_field()
    challenges[CH_BETA] = transcript.get_field()
    _abort_point()
    cm3_n = round3(air, setup.const_n, cm1_n, cm2_n,
                   _challenges_array(challenges, device), publics_arr, x_n,
                   l1_n)
    del cm1_n, cm2_n     # rounds 4-5 and FRI read the ext domain only
    cm3_ext, tree3 = _extend_commit(scheme, sp, cm3_n, air, device)
    del cm3_n
    root3 = scheme.root(tree3)
    transcript.put(root3)
    lap("step3")

    # ---- round 4: quotient --------------------------------------------
    challenges[CH_VC] = transcript.get_field()
    sections_ext = {"const": setup.const_ext, "cm1": cm1_ext,
                    "cm2": cm2_ext, "cm3": cm3_ext}
    cm4_ext = quotient(air, sections_ext,
                       _challenges_array(challenges, device), publics_arr,
                       x_ext, l1_ext, zi_ext, rows,
                       mem=qmem if stats is not None else None)
    tree4 = scheme.merkelize(cm4_ext, air.cm4_width)
    if sp.stream:
        cm4_ext = _to_host(cm4_ext, device)
    root4 = scheme.root(tree4)
    transcript.put(root4)
    lap("step4")

    # ---- round 5: evals + DEEP/FRI polynomial ---------------------------
    challenges[CH_XI] = transcript.get_field()
    sections_ext["cm4"] = cm4_ext
    evals_arr = _round5_with(air, sections_ext, challenges, x_ext, "evals",
                             rows=rows5)
    evals = [[int(v) for v in row] for row in gl.to_u64_np(evals_arr)]
    for ev in evals:
        transcript.put(ev)
    challenges[CH_V1] = transcript.get_field()
    challenges[CH_V2] = transcript.get_field()
    fri_pol = _round5_with(air, sections_ext, challenges, x_ext, "fri",
                           evals_arr, rows=rows5)
    lap("step5")

    # ---- FRI ------------------------------------------------------------
    fri_steps_data, final_pol, _ys = fri_mod.prove(
        transcript, fri_pol, air,
        [tree1, tree2, tree3, tree4, setup.const_tree],
        [cm1_ext, cm2_ext, cm3_ext, cm4_ext, setup.const_ext], scheme)
    lap("fri")
    if stats is not None:
        stats["copies"] = {k: {"bytes": v[0], "s": v[1]}
                           for k, v in dev.COPIES.items()}

    return StarkProof(roots=[root1, root2, root3, root4], evals=evals,
                      fri_steps=fri_steps_data, final_pol=final_pol,
                      publics=publics)
