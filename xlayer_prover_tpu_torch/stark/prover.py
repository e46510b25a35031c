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

Sections are (rows, cols) int64 tensors on the device; the round
functions are plain PyTorch over them (every Goldilocks product through
the ``gl_mul`` kernel, every hash through ``poseidon_permute`` on a GPU).
The host handles only transcript scalars, the plookup missing-value count
and the proof assembly.
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
from . import air as air_mod
from . import fri as fri_mod
from . import lookup
from .air import CH_BETA, CH_DEFVAL, CH_GAMMA, CH_U, CH_V1, CH_V2, CH_VC, CH_XI
from .commitment import get_scheme
from .eval import EvalEnv, count_refs
from .proof import StarkProof

P = gl.P


class LookupMissingError(ValueError):
    """A plookup's f holds values that its table t lacks."""


class ProofCancelled(Exception):
    """Raised between rounds when an abort_check callback fires (the
    cooperative mid-proof cancellation the reference lacks — its
    cancel only skips queued jobs, prover.cpp:300-349)."""


@dataclasses.dataclass
class Setup:
    """Preprocessed data: constant polynomials, their LDE and tree (verkey)."""
    air: object
    const_n: torch.Tensor
    const_ext: torch.Tensor
    const_tree: object
    verkey: list
    device: torch.device

    @staticmethod
    def build(air, const_np: np.ndarray, device=None) -> "Setup":
        """Constant LDE + tree on `device` (None: the GPU)."""
        device = dev.resolve(device)
        if const_np.shape != (air.n, air.const_width):
            raise ValueError(f"const_np shape {const_np.shape} != "
                             f"{(air.n, air.const_width)}")
        scheme = get_scheme(air)
        const_n = gl.from_u64_np(const_np.astype(np.uint64), device)
        if air.const_width:
            const_ext = ntt.extend_pol(const_n, air.n_bits_ext)
        else:
            const_ext = gl.zeros((air.n_ext, 0), device)
        tree = scheme.merkelize(const_ext, air.const_width)
        return Setup(air=air, const_n=const_n, const_ext=const_ext,
                     const_tree=tree, verkey=scheme.root(tree), device=device)

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
    def load(path: str, air, device=None) -> "Setup":
        """Load a ``save`` artifact (the port's or the JAX package's) onto
        `device` (None: the GPU); shape-checked against the air.  The
        artifact holds a GL tree, as in the JAX package."""
        device = dev.resolve(device)
        if get_scheme(air).name != "gl":
            raise ValueError("constants artifacts hold GL Merkle trees")
        with np.load(path) as z:
            const_n_np = z["const_n"]
            if const_n_np.shape != (air.n, air.const_width):
                raise ValueError("constants artifact does not match this "
                                 "air geometry")
            levels = [gl.from_u64_np(z[f"level{i}"], device)
                      for i in range(int(z["n_levels"]))]
            const_ext = gl.from_u64_np(z["const_ext"], device)
            verkey = [int(v) for v in z["verkey"]]
        tree = merkle.MerkleTree(levels=tuple(levels), width=air.const_width)
        return Setup(air=air, const_n=gl.from_u64_np(const_n_np, device),
                     const_ext=const_ext, const_tree=tree, verkey=verkey,
                     device=device)


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


def quotient(air, const_ext, cm1e, cm2e, cm3e, ch, publics, x_ext, l1_ext,
             zi_ext):
    """Constraints combined by powers of vc, divided by Z_H, split into
    q_deg chunks of degree < N and extended -> cm4_ext (n_ext, q_deg*3)."""
    n, n_ext = air.n, air.n_ext
    constraints = air_mod.all_constraints(air)
    env = EvalEnv({"const": const_ext, "cm1": cm1e, "cm2": cm2e, "cm3": cm3e},
                  _challenges_env(ch), _pubs(air, publics), x_ext, l1_ext,
                  n_ext // n, refcounts=count_refs(constraints))
    vc = tuple(ch[CH_VC, k] for k in range(3))
    acc = None
    for c in constraints:
        val = env.eval_ext(c)
        acc = val if acc is None else gl3.add(gl3.mul(acc, vc), val)
    q_vals = tuple(gl.mul(c, zi_ext) for c in _broad3(acc, n_ext))
    q_coeffs = ntt.intt(gl3.stack_cols(q_vals), air.n_bits_ext)
    shift_in = pow(gl.host_inv(gl.SHIFT), n, P)
    parts = []
    cur_s = 1
    for p_i in range(air.q_deg):
        chunk = gl.mul_const(q_coeffs[p_i * n:(p_i + 1) * n], cur_s)
        cur_s = (cur_s * shift_in) % P
        chunk = torch.cat([chunk, gl.zeros((n_ext - n, 3), x_ext.device)])
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


def round5(air, sections_ext, ch, x_ext, phase: str, evals_arr=None):
    """phase "evals": (n_ev, 3) evaluations at the shifted xi points.
    phase "fri": the DEEP/FRI polynomial (gl3 triple over the ext domain),
    from `evals_arr`."""
    n_ext = air.n_ext
    blowup = n_ext // air.n
    device = x_ext.device
    shifts = sorted({e.shift for e in air.ev_map})
    w_n = gl.host_w(air.n_bits)
    xi = tuple(ch[CH_XI, k] for k in range(3))
    if phase == "evals":
        shift_inv = gl.host_inv(gl.SHIFT)
        weights = {s_: _lagrange_weights(gl3.mul_base(xi, dev.scalar(
            (pow(w_n, s_, P) * shift_inv) % P, device)), air.n_bits)
            for s_ in shifts}
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
    if phase != "fri":
        raise ValueError(f"round5: unknown phase {phase!r}")
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


def _round5_with(air, sections_ext, challenges, x_ext, phase,
                 evals_arr=None):
    return round5(air, sections_ext, _challenges_array(challenges,
                                                       x_ext.device),
                  x_ext, phase, evals_arr)


# ---------------------------------------------------------------------------
# The proof
# ---------------------------------------------------------------------------

def gen_proof(setup: Setup, cm1_np: np.ndarray, publics,
              timings: dict | None = None,
              abort_check=None) -> StarkProof:
    """Prove the trace `cm1_np` (n, cm1_width) uint64 on `setup.device`.

    timings: if a dict is given, the wall seconds of each round (keys
    step1..step5, fri) are written into it.  Each round ends by pulling
    its Merkle root (or the evals) to the host, which waits for the
    device, so the times are device times plus host work.

    abort_check: optional zero-arg callable polled at two round
    boundaries, before step 2 and before step 3; returning True raises
    ProofCancelled."""
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
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock[0]
        clock[0] = now

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
    cm1_ext = ntt.extend_pol(cm1_n, air.n_bits_ext)
    tree1 = scheme.merkelize(cm1_ext, air.cm1_width)
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
    if air.cm2_width:
        cm2_ext = ntt.extend_pol(cm2_n, air.n_bits_ext)
    else:
        cm2_ext = gl.zeros((n_ext, 0), device)
    tree2 = scheme.merkelize(cm2_ext, air.cm2_width)
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
    if air.cm3_width:
        cm3_ext = ntt.extend_pol(cm3_n, air.n_bits_ext)
    else:
        cm3_ext = gl.zeros((n_ext, 0), device)
    del cm1_n, cm2_n, cm3_n     # rounds 4-5 and FRI read the ext domain only
    tree3 = scheme.merkelize(cm3_ext, air.cm3_width)
    root3 = scheme.root(tree3)
    transcript.put(root3)
    lap("step3")

    # ---- round 4: quotient --------------------------------------------
    challenges[CH_VC] = transcript.get_field()
    cm4_ext = quotient(air, setup.const_ext, cm1_ext, cm2_ext, cm3_ext,
                       _challenges_array(challenges, device), publics_arr,
                       x_ext, l1_ext, zi_ext)
    tree4 = scheme.merkelize(cm4_ext, air.cm4_width)
    root4 = scheme.root(tree4)
    transcript.put(root4)
    lap("step4")

    # ---- round 5: evals + DEEP/FRI polynomial ---------------------------
    challenges[CH_XI] = transcript.get_field()
    sections_ext = {"const": setup.const_ext, "cm1": cm1_ext,
                    "cm2": cm2_ext, "cm3": cm3_ext, "cm4": cm4_ext}
    evals_arr = _round5_with(air, sections_ext, challenges, x_ext, "evals")
    evals = [[int(v) for v in row] for row in gl.to_u64_np(evals_arr)]
    for ev in evals:
        transcript.put(ev)
    challenges[CH_V1] = transcript.get_field()
    challenges[CH_V2] = transcript.get_field()
    fri_pol = _round5_with(air, sections_ext, challenges, x_ext, "fri",
                           evals_arr)
    lap("step5")

    # ---- FRI ------------------------------------------------------------
    fri_steps_data, final_pol, _ys = fri_mod.prove(
        transcript, fri_pol, air,
        [tree1, tree2, tree3, tree4, setup.const_tree],
        [cm1_ext, cm2_ext, cm3_ext, cm4_ext, setup.const_ext], scheme)
    lap("fri")

    return StarkProof(roots=[root1, root2, root3, root4], evals=evals,
                      fri_steps=fri_steps_data, final_pol=final_pol,
                      publics=publics)
