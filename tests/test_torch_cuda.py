"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test needs a GPU: it is marked ``cuda`` and skips when
``torch.cuda.is_available()`` is false.  The file imports nothing of JAX,
so on the machine with the card it runs without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from xlayer_prover_tpu_torch import kernels
from xlayer_prover_tpu_torch.fields import gl
from xlayer_prover_tpu_torch.models.toy import fib
from xlayer_prover_tpu_torch.ops import (bn254_mont, merkle, poseidon_bn254,
                                         poseidon_gl)
from xlayer_prover_tpu_torch.stark import commitment, prover, verifier

P = gl.P
EDGES = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, 1 << 63,
                  P, P + 1, (1 << 64) - 1], dtype=np.uint64)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(20261016)


def test_gl_mul_kernel_matches_plain(gen, cuda_device):
    a = gen.integers(0, P, size=1 << 16, dtype=np.uint64)
    b = gen.integers(0, P, size=1 << 16, dtype=np.uint64)
    a[:EDGES.size ** 2] = np.repeat(EDGES, EDGES.size)
    b[:EDGES.size ** 2] = np.tile(EDGES, EDGES.size)
    ta = gl.from_u64_np(a, cuda_device)
    tb = gl.from_u64_np(b, cuda_device)
    before = kernels.LAUNCHES["gl_mul"]
    assert torch.equal(gl.gl_mul(ta, tb), gl._mul_plain(ta, tb))
    assert kernels.LAUNCHES["gl_mul"] == before + 1
    s = tb[5].clone()
    assert torch.equal(gl.gl_mul(ta, s), gl._mul_plain(ta, s))
    with pytest.raises(ValueError):
        gl.gl_mul(ta[::2], tb[::2])


def test_poseidon_kernel_matches_plain(gen, cuda_device):
    states = gen.integers(0, P, size=(1000, 12), dtype=np.uint64)
    states[:EDGES.size] = EDGES[:, None]
    states[EDGES.size] = [(1 << 64) - 1 - k for k in range(12)]
    t = gl.from_u64_np(states, cuda_device)
    before = kernels.LAUNCHES["poseidon_permute"]
    got = poseidon_gl.permute(t)
    assert kernels.LAUNCHES["poseidon_permute"] == before + 1
    assert torch.equal(got, poseidon_gl._permute_plain(t))
    assert [int(v) for v in gl.to_u64_np(got[7])] == \
        poseidon_gl.host_permute([int(v) for v in states[7]])
    with pytest.raises(ValueError):
        poseidon_gl.permute(t[:, :8].contiguous())


@pytest.mark.parametrize("width", [5, 8, 9, 39])
def test_linear_hash_kernel_matches_plain(gen, cuda_device, width):
    rows = gen.integers(0, P, size=(1000, width), dtype=np.uint64)
    rows[:EDGES.size] = EDGES[:, None]
    rows[EDGES.size] = [(1 << 64) - 1 - k for k in range(width)]
    t = gl.from_u64_np(rows, cuda_device)
    before = kernels.LAUNCHES["poseidon_linear_hash"]
    got = poseidon_gl.linear_hash(t, width)
    assert kernels.LAUNCHES["poseidon_linear_hash"] == before + 1
    assert torch.equal(got, poseidon_gl._linear_hash_plain(t, width))
    assert [int(v) for v in gl.to_u64_np(got[EDGES.size])] == \
        poseidon_gl.host_linear_hash([int(v) for v in rows[EDGES.size]])
    wide = gl.from_u64_np(np.zeros((16, 2 * width), dtype=np.uint64),
                          cuda_device)
    with pytest.raises(ValueError):
        poseidon_gl.linear_hash(wide[:, ::2], width)


@pytest.mark.parametrize("width,block", [(9, 8), (39, 16), (669, 64)])
def test_linear_hash_kernel_carried_capacity(gen, cuda_device, width, block):
    """RATE-aligned column blocks read in place (the row stride of the
    whole width), each digest carried into the next block, give the
    one-shot digest and the plain version's."""
    rows = gen.integers(0, P, size=(1000, width), dtype=np.uint64)
    rows[:EDGES.size] = EDGES[:, None]
    t = gl.from_u64_np(rows, cuda_device)
    dig = plain = None
    before = kernels.LAUNCHES["poseidon_linear_hash"]
    for c0 in range(0, width, block):
        w = min(block, width - c0)
        dig = poseidon_gl.linear_hash(t[:, c0:c0 + w], w, dig)
        plain = poseidon_gl._linear_hash_plain(t[:, c0:c0 + w], w, plain)
    assert kernels.LAUNCHES["poseidon_linear_hash"] == \
        before + -(-width // block)
    assert torch.equal(dig, poseidon_gl.linear_hash(t, width))
    assert torch.equal(dig, plain)


def test_streamed_proof_on_cuda_equals_resident(cuda_device):
    """The Binary SM at n_bits 10 under a budget that streams: the host
    sections page-locked, the proof the JAX package's byte for byte."""
    from tools import torch_proof_fixtures as fixtures
    air, _layout, const_np, cm1, _ = fixtures.binary_sm_case(
        "xlayer_prover_tpu_torch")
    budget = 2 << 20
    assert prover.section_plan(air, cuda_device, budget).stream
    setup = prover.Setup.build(air, const_np, device=cuda_device,
                               hbm_bytes=budget)
    assert not setup.const_ext.is_cuda
    stats = {}
    proof = prover.gen_proof(setup, cm1, [], stats=stats)
    assert stats["windows"] > 1 and stats["copies"]["h2d"]["bytes"] > 0
    assert proof.to_json() == fixtures.read("binary_sm_n10_q4")
    assert verifier.verify(air, setup.verkey, proof)


def test_merkelize_on_cuda_equals_cpu(gen, cuda_device):
    rows = gen.integers(0, P, size=(1 << 10, 39), dtype=np.uint64)
    cpu = merkle.merkelize(gl.from_u64_np(rows, "cpu"), 39)
    before = kernels.LAUNCHES["poseidon_linear_hash"]
    tree = merkle.merkelize(gl.from_u64_np(rows, cuda_device), 39)
    assert kernels.LAUNCHES["poseidon_linear_hash"] == before + 11
    assert np.array_equal(tree.root_np(), cpu.root_np())
    for lv, clv in zip(tree.levels, cpu.levels):
        assert np.array_equal(gl.to_u64_np(lv), gl.to_u64_np(clv))


def test_fib_proof_on_cuda_equals_cpu(cuda_device):
    air = fib.build_air(n_bits=5, n_queries=8)
    const_np, cm1_np, publics = fib.gen_trace(air)
    cpu = prover.gen_proof(prover.Setup.build(air, const_np, device="cpu"),
                           cm1_np, publics)
    setup = prover.Setup.build(air, const_np, device=cuda_device)
    gpu = prover.gen_proof(setup, cm1_np, publics)
    assert gpu.to_json() == cpu.to_json()
    assert verifier.verify(air, setup.verkey, gpu)


def test_zkevm_mini_proof_on_cuda_equals_jax_fixture(cuda_device):
    """The mini-ROM's composite proof at n_bits 13 on the card is the JAX
    package's, byte for byte (tests/data/zkevm_mini_n13_q4.proof.json)."""
    from xlayer_prover_tpu_torch.models.zkevm import mini_rom

    from tools import torch_proof_fixtures as fixtures
    ex, res = mini_rom.execute(13)
    setup = prover.Setup.build(ex.air, res.const_np)
    proof = prover.gen_proof(setup, res.cm1_np, res.publics)
    assert proof.to_json() == fixtures.read("zkevm_mini_n13_q4")
    assert verifier.verify(ex.air, setup.verkey, proof)


FR = poseidon_bn254.P
FR_EDGES = [0, 1, FR - 1, FR, FR + 1, (1 << 256) - 1]
# states 6 and 7: lanes mixed over the edges, and r - 1 beside 2^256 - 1
FR_MIXED = [(FR - 1, 0, FR, (1 << 256) - 1, 1), (FR - 1, (1 << 256) - 1)]


def _fr_states(gen, n, t):
    vals = [int.from_bytes(gen.bytes(32), "little") for _ in range(n * t)]
    for k, e in enumerate(FR_EDGES):
        vals[k * t:(k + 1) * t] = [e] * t
    for k, cyc in enumerate(FR_MIXED, len(FR_EDGES)):
        vals[k * t:(k + 1) * t] = [cyc[i % len(cyc)] for i in range(t)]
    return vals, torch.from_numpy(
        bn254_mont.to_words(vals)).reshape(n, t, 4)


@pytest.mark.parametrize("t", range(2, 18))
def test_bn254_permute_kernel_matches_plain(gen, cuda_device, t):
    """Every width, on the edge and mixed extreme states, a ragged last
    warp (300 states, 8 a warp) included."""
    vals, states = _fr_states(gen, 300, t)
    x = states.to(cuda_device)
    before = kernels.LAUNCHES["poseidon_bn254_permute"]
    got = poseidon_bn254.permute(x, t)
    assert kernels.LAUNCHES["poseidon_bn254_permute"] == before + 1
    assert torch.equal(got, poseidon_bn254._permute_plain(x, t))
    for k in (0, 2, 3, 5, 6, 7, 9):
        assert bn254_mont.from_words(got[k]) == \
            poseidon_bn254.host_permute(vals[k * t:(k + 1) * t])
    with pytest.raises(ValueError):
        poseidon_bn254.permute(x[:, :, :2].contiguous(), t)


@pytest.mark.parametrize("t", [2, 5, 6, 9, 14, 17])
def test_bn254_permute_kernel_at_each_group_size(gen, cuda_device, t):
    """A batch too small to fill the card at 4 lanes a state runs at 8,
    a larger one at 4, and t <= 5 at one lane: both sides of the
    library's line, ragged, equal the plain version."""
    few = kernels.load("poseidon_bn254").poseidon_bn254_few_states()
    for n in (few - 3, few + 5):
        _vals, states = _fr_states(gen, n, t)
        x = states.to(cuda_device)
        assert torch.equal(poseidon_bn254.permute(x, t),
                           poseidon_bn254._permute_plain(x, t))


@pytest.mark.parametrize("width", [0, 1, 3, 4, 5, 6, 39, 48, 51, 60, 519])
def test_bn254_leaf_hash_kernel_matches_plain(gen, cuda_device, width):
    """The widths of the final stage's trees (60, 39, 51, 6) and the
    edges of the packing, on edge rows, rows of alternate 0 and 2^64 - 1
    and seeded rows."""
    rows = gen.integers(0, 1 << 64, size=(300, width), dtype=np.uint64,
                        endpoint=False)
    if width:
        rows[:EDGES.size] = EDGES[:, None]
        rows[EDGES.size, ::2] = 0
        rows[EDGES.size, 1::2] = (1 << 64) - 1
    t = gl.from_u64_np(rows, cuda_device)
    before = kernels.LAUNCHES["poseidon_bn254_leaf_hash"]
    got = poseidon_bn254.leaf_hash(t, width)
    assert kernels.LAUNCHES["poseidon_bn254_leaf_hash"] == before + 1
    assert torch.equal(got, poseidon_bn254._leaf_hash_plain(t, width))
    assert bn254_mont.from_words(got[[2, 9, 10, 11, 12]]) == [
        poseidon_bn254.leaf_hash_host([int(v) for v in rows[k]])
        for k in (2, 9, 10, 11, 12)]


def test_bn128_tree_on_cuda_equals_cpu(gen, cuda_device):
    rows = gen.integers(0, P, size=(1 << 10, 60), dtype=np.uint64)
    scheme = commitment.BN128Scheme()
    cpu = scheme.merkelize(gl.from_u64_np(rows, "cpu"), 60)
    before = dict(kernels.LAUNCHES)
    tree = scheme.merkelize(gl.from_u64_np(rows, cuda_device), 60)
    assert kernels.LAUNCHES["poseidon_bn254_leaf_hash"] == \
        before["poseidon_bn254_leaf_hash"] + 1
    assert kernels.LAUNCHES["poseidon_bn254_permute"] == \
        before["poseidon_bn254_permute"] + 3          # 1024 -> 64 -> 4 -> 1
    for lv, clv in zip(tree.levels, cpu.levels, strict=True):
        assert torch.equal(lv.cpu(), clv)
    src = gl.from_u64_np(rows, cuda_device)
    idxs = [0, 5, 1023, 600]
    assert scheme.open_many(tree, src, idxs) == \
        scheme.open_many(cpu, gl.from_u64_np(rows, "cpu"), idxs)


def test_fib_bn128_proof_on_cuda_equals_jax_fixture(cuda_device):
    """The fib proof over the bn128 scheme on the card is the JAX
    package's, byte for byte (tests/data/fib_bn128_n4_q2.proof.json)."""
    from tools import torch_proof_fixtures as fixtures
    air, _layout, const_np, cm1, publics = fixtures.fib_bn128_case(
        "xlayer_prover_tpu_torch")
    setup = prover.Setup.build(air, const_np, device=cuda_device)
    proof = prover.gen_proof(setup, cm1, publics)
    assert proof.to_json() == fixtures.read("fib_bn128_n4_q2")
    assert verifier.verify(air, setup.verkey, proof)


# ---------------------------------------------------------------------------
# Groth16's kernels: the BN254 MSM, fixed-base multiplication, the Fr NTT
# ---------------------------------------------------------------------------

def _words(values, device):
    return torch.from_numpy(bn254_mont.to_words(values)).to(device)


def msm_case(group, n, seed, c=None):
    """``bn254_msm.msm_cases`` (every edge of the MSM kernels for c-bit
    signed windows) -> (host points, scalars, point words)."""
    from xlayer_prover_tpu_torch.ops import bn254_msm
    pts, sc = bn254_msm.msm_cases(group, n, seed, c)
    words = bn254_msm.g2_words(pts) if group == "g2" else \
        bn254_msm.g1_words(pts)
    return pts, sc, torch.from_numpy(words)


@pytest.mark.parametrize("group,n", [("g1", 4096), ("g2", 1024),
                                     ("g1", 4099), ("g2", 1027),
                                     ("g1", 1 << 14), ("g2", 1 << 14)])
def test_bn254_msm_kernel_matches_plain(cuda_device, group, n):
    """Every edge of msm_case, at 2^14 and at sizes whose entries end in a
    ragged chunk: the kernels equal the plain version in affine, and at
    2^14 the step-by-step model too."""
    from xlayer_prover_tpu_torch.ops import bn254_msm
    _pts, sc, words = msm_case(group, n, 20261017)
    x, s = words.to(cuda_device), _words(sc, cuda_device)
    fn = getattr(bn254_msm, f"msm_{group}")
    F = bn254_msm.FQ1_OPS if group == "g1" else bn254_msm.FQ2_OPS
    affine = getattr(bn254_msm, f"to_affine_{group}")
    name = f"bn254_msm_{group}"
    before = kernels.LAUNCHES[name]
    got = fn(x, s)
    assert kernels.LAUNCHES[name] == before + 1
    assert got.device.type == "cuda"
    assert affine(got) == affine(bn254_msm._msm_plain(F, x, s))
    if n == 1 << 14:
        assert affine(got) == affine(bn254_msm._msm_model(F, x, s))
    assert affine(fn(x, torch.zeros_like(s))) is None
    assert affine(fn(x[:1], s[2:3])) == affine(
        bn254_msm._msm_plain(F, x[:1], s[2:3]))


@pytest.mark.parametrize("group,n,c", [("g1", 1000, 2), ("g1", 1000, 3),
                                       ("g1", 1000, 5), ("g1", 600, 16),
                                       ("g2", 300, 2), ("g2", 300, 4),
                                       ("g2", 200, 16)])
def test_bn254_msm_kernel_window_widths(cuda_device, group, n, c):
    """msm_case at a chosen window width (c = 2: 128 windows of two
    buckets; c = 16: 2^15 buckets a window, mostly empty): the kernels
    equal the plain version and the step-by-step model in affine."""
    from xlayer_prover_tpu_torch.ops import bn254_msm
    _pts, sc, words = msm_case(group, n, 20261020 + c, c)
    x, s = words.to(cuda_device), _words(sc, cuda_device)
    F = bn254_msm.FQ1_OPS if group == "g1" else bn254_msm.FQ2_OPS
    affine = getattr(bn254_msm, f"to_affine_{group}")
    got = affine(bn254_msm._msm(f"bn254_msm_{group}", F, x, s, c=c))
    assert got == affine(bn254_msm._msm_plain(F, x, s))
    assert got == affine(bn254_msm._msm_model(F, x, s, c))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bn254_msm_prepare_keys_match_plain(cuda_device, group):
    """msm_prepare's keys (signed digits, MSM_NONE for zero digits and
    points at infinity) equal msm_keys at every window width, and its
    Montgomery table holds the points."""
    from xlayer_prover_tpu_torch.ops import bn254_msm
    _pts, sc, words = msm_case(group, 257, 20261021)
    x, s = words.to(cuda_device), _words(sc, cuda_device)
    name = f"bn254_msm_{group}"
    lib = kernels.load(name)
    for c in range(2, bn254_msm.MAX_WINDOW_BITS + 1):
        w = bn254_msm.n_windows(c)
        keys = torch.empty(w * 257, dtype=torch.int32, device=cuda_device)
        mont = torch.empty_like(x)
        kernels.check(getattr(lib, f"{name}_prepare")(
            x.data_ptr(), s.data_ptr(), 257, c, w, mont.data_ptr(),
            keys.data_ptr(), kernels.stream_ptr(cuda_device)), name)
        assert torch.equal(keys, bn254_msm.msm_keys(x, s, c)), c


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bn254_msm_kernel_waits_for_no_host(cuda_device, group):
    """Between the upload of the scalars and the Jacobian result the MSM
    path synchronises with the host nowhere: PyTorch's sync debug mode
    raises on any synchronising op."""
    from xlayer_prover_tpu_torch.ops import bn254_msm
    _pts, sc, words = msm_case(group, 1024, 20261022)
    x, s = words.to(cuda_device), _words(sc, cuda_device)
    fn = getattr(bn254_msm, f"msm_{group}")
    want = fn(x, s)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(x, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bn254_msm_kernel_at_main_path_windows(cuda_device, group):
    """2^20 points (16-bit windows, as the devnet root's MSMs) made by the
    fixed-base kernel, every 128th scalar and the edge rows of msm_case
    kept and the rest 0: the kernel equals the plain version over the kept
    rows (the others add nothing)."""
    import random

    from xlayer_prover_tpu_torch.fields import bn254, bn254_tower
    from xlayer_prover_tpu_torch.ops import bn254_msm
    n = 1 << 20
    assert bn254_msm.window_bits(n) == 16
    rng = random.Random(20261018)
    r = bn254.R
    gen = bn254.G1_GEN if group == "g1" else bn254_tower.G2_GEN
    x = getattr(bn254_msm, f"fixed_base_{group}")(gen, _words(
        [rng.randrange(1, 1 << 64) for _ in range(n)], cuda_device))
    _pts, sc, edge = msm_case(group, 64, 20261019, 16)
    x[:64] = edge.to(cuda_device)
    keep = torch.arange(n, device=cuda_device)
    keep = (keep % 128 == 0) | (keep < 64)
    sc = sc + [rng.randrange(r) if k % 128 == 0 else 0
               for k in range(64, n)]
    sc[n // 4:n // 2:128] = [1] * len(sc[n // 4:n // 2:128])
    s = _words(sc, cuda_device)
    F = bn254_msm.FQ1_OPS if group == "g1" else bn254_msm.FQ2_OPS
    affine = getattr(bn254_msm, f"to_affine_{group}")
    got = getattr(bn254_msm, f"msm_{group}")(x, s)
    assert affine(got) == affine(bn254_msm._msm_plain(F, x[keep], s[keep]))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bn254_fixed_base_kernel_matches_plain(cuda_device, group):
    """2^12 + 37 scalars of bn254_msm.fixed_base_cases (every edge, blocks
    all at infinity, a block with one live lane, a ragged last block):
    the kernel equals the plain version bit for bit."""
    from xlayer_prover_tpu_torch.fields import bn254, bn254_tower
    from xlayer_prover_tpu_torch.ops import bn254_msm
    ks = bn254_msm.fixed_base_cases((1 << 12) + 37, 7)
    s = _words(ks, cuda_device)
    gen = bn254.G1_GEN if group == "g1" else bn254_tower.G2_GEN
    F = bn254_msm.FQ1_OPS if group == "g1" else bn254_msm.FQ2_OPS
    fn = getattr(bn254_msm, f"fixed_base_{group}")
    name = f"bn254_fixed_base_{group}"
    before = kernels.LAUNCHES[name]
    got = fn(gen, s)
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(got, bn254_msm._fixed_base_plain(F, gen, s))
    assert not got[0].any()
    w = bn254_msm.FB_CASE_BLOCK
    live = got[2 * w:4 * w].any(-1).nonzero().flatten().tolist()
    assert live == [w + 77]
    pts = getattr(bn254_msm, f"{group}_points")(got[4:6].cpu())
    if group == "g1":
        g = bn254.g1_from_affine(bn254.G1_GEN)
        assert pts == [bn254.g1_to_affine(bn254.g1_mul(g, k))
                       for k in ks[4:6]]
    else:
        assert pts == [bn254_tower.g2_mul(gen, k) for k in ks[4:6]]


# either side of each pass boundary of fr_ntt (2^11 values a block): one
# pass up to 2^11, two up to 2^22, three beyond; 2^20 and 2^21 are the
# Groth16 shapes
NTT_BITS = [0, 1, 2, 3, 7, 10, 11, 12, 20, 21, 22, 23]


def _device_kernels(fn) -> list:
    """Names of the device kernels that one call of fn launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("bits", NTT_BITS)
def test_fr_ntt_kernel_matches_plain(cuda_device, bits):
    import random

    from xlayer_prover_tpu_torch.fields import bn254
    from xlayer_prover_tpu_torch.ops import ntt_fr
    rng = random.Random(bits)
    vals = [rng.randrange(bn254.R) for _ in range(1 << bits)]
    vals[0] = bn254.R - 1
    x = _words(vals, cuda_device)
    x0 = x.clone()
    for inverse in (False, True):
        before = kernels.LAUNCHES["fr_ntt"]
        got = ntt_fr.ntt(x, inverse)
        assert kernels.LAUNCHES["fr_ntt"] == before + 1
        assert torch.equal(got, ntt_fr._ntt_plain(x, inverse))
        assert torch.equal(x, x0)                    # vals is never written
    assert torch.equal(ntt_fr.ntt(ntt_fr.ntt(x), inverse=True), x)


@pytest.mark.parametrize("bits", [5, 11, 12, 21])
def test_fr_ntt_kernel_edge_values(cuda_device, bits):
    """All 0, all 1, all r - 1, all r - 2, and the four in turn."""
    from xlayer_prover_tpu_torch.fields import bn254
    from xlayer_prover_tpu_torch.ops import ntt_fr
    r = bn254.R
    edges = [0, 1, r - 1, r - 2]
    n = 1 << bits
    cases = [_words([v], cuda_device).expand(n, 4).contiguous()
             for v in edges]
    cases.append(_words(edges, cuda_device).repeat(n // 4, 1))
    for x in cases:
        for inverse in (False, True):
            assert torch.equal(ntt_fr.ntt(x, inverse),
                               ntt_fr._ntt_plain(x, inverse))


@pytest.mark.parametrize("bits", [1, 2, 3, 12, 20, 21, 23])
def test_fr_ntt_device_table_equals_host(cuda_device, bits):
    """The table expanded on the card equals the host-built one (the
    Montgomery form of _powers) word for word: one fr_ntt_twiddles launch
    a host part after the first."""
    from xlayer_prover_tpu_torch.fields import bn254
    from xlayer_prover_tpu_torch.ops import ntt_fr
    for inverse in (False, True):
        ntt_fr._kernel_twiddles.cache_clear()
        before = kernels.LAUNCHES["fr_ntt_twiddles"]
        table = ntt_fr._kernel_twiddles(bits, inverse, cuda_device)
        assert kernels.LAUNCHES["fr_ntt_twiddles"] == \
            before + len(ntt_fr._twiddle_parts(bits)) - 1
        want = bn254_mont.to_words(v * bn254_mont.MONT % bn254.R
                                   for v in ntt_fr._powers(bits, inverse))
        assert torch.equal(table.cpu(), torch.from_numpy(want))
        ntt_fr._powers.cache_clear()
    ntt_fr._kernel_twiddles.cache_clear()


@pytest.mark.parametrize("bits", [12, 20, 21, 23])
def test_fr_ntt_device_launches(cuda_device, bits):
    """A warm call launches one kernel a pass and nothing else: 2 at
    2^20 and 2^21 (22 and 23 before the redesign), 3 beyond 2^22; the
    library's own count (ntt_fr.device_launches) agrees."""
    from xlayer_prover_tpu_torch.ops import ntt_fr
    x = torch.zeros((1 << bits, 4), dtype=torch.int64, device=cuda_device)
    for inverse in (False, True):
        ntt_fr.ntt(x, inverse)
        before = ntt_fr.device_launches()
        names = _device_kernels(lambda: ntt_fr.ntt(x, inverse))
        assert len(names) == len(ntt_fr._passes(bits)) <= 3, names
        assert all("ntt_pass" in name for name in names), names
        assert ntt_fr.device_launches() - before == len(names)


def test_fr_mul_sub_kernel_matches_plain(cuda_device):
    import random

    from xlayer_prover_tpu_torch.fields import bn254
    from xlayer_prover_tpu_torch.ops import ntt_fr
    rng = random.Random(3)
    r = bn254.R
    a, b, c = (_words([0, 1, r - 1] + [rng.randrange(r) for _ in range(997)],
                      cuda_device) for _ in range(3))
    before = kernels.LAUNCHES["fr_mul_sub"]
    got = ntt_fr.mul_sub(a, b, c)
    assert kernels.LAUNCHES["fr_mul_sub"] == before + 1
    assert torch.equal(got, ntt_fr._mul_sub_plain(a, b, c))


def test_groth16_on_cuda_equals_cpu(cuda_device):
    """Setup and proof of the cubic circuit with random.Random(42) on the
    card and on the CPU (the plain versions): the same keys and proof."""
    import dataclasses
    import random

    from xlayer_prover_tpu_torch.fields.bn254 import R
    from xlayer_prover_tpu_torch.snark import groth16
    from xlayer_prover_tpu_torch.snark.r1cs import R1CSBuilder
    b = R1CSBuilder()
    out = b.public((27 + 3 + 5) % R)
    xw = b.wire(3)
    x3 = b.mul(b.mul(xw, xw), xw)
    b.assert_eq_lc({x3: 1, xw: 1}, 5, out)
    r1cs, wit = b.build(), b.witness()
    results = []
    for dev in (cuda_device, "cpu"):
        rng = random.Random(42)
        pk, vk = groth16.setup(r1cs, rng=rng, device=dev)
        proof = groth16.prove(pk, r1cs, wit, rng=rng)
        hpk, hvk = groth16.keys_to_host(pk, vk)
        results.append((dataclasses.asdict(hpk), hvk, proof))
    assert results[0] == results[1]
    assert groth16.verify(results[0][1], results[0][2], [wit[1]])


def _fr_words(gen, n, device):
    """(n, 4) words below 2^252 (< r), the first rows 0, 1, r - 1, r - 2."""
    from xlayer_prover_tpu_torch.fields.bn254 import R
    x = gen.integers(0, 1 << 63, size=(n, 4), dtype=np.int64)
    x[:, 3] &= (1 << 60) - 1
    edges = bn254_mont.to_words([0, 1, R - 1, R - 2])
    x[:min(n, 4)] = edges[:min(n, 4)]
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("n", [1, 33, 1025, 1 << 16])
def test_fr_eval_kernel_matches_plain(gen, cuda_device, n):
    from xlayer_prover_tpu_torch.fields.bn254 import R
    from xlayer_prover_tpu_torch.ops import fr_poly
    p = _fr_words(gen, n, cuda_device)
    xs = [0, 1, R - 1, 12345, 2 ** 200 + 7]
    before = kernels.LAUNCHES["fr_eval"]
    got = fr_poly.evaluate(p, xs)
    assert kernels.LAUNCHES["fr_eval"] == before + 1
    assert got == fr_poly._eval_plain(p, xs)


@pytest.mark.parametrize("k", [1, 3, 4, 8, 9, 1 << 12])
def test_fr_div_binomial_kernel_matches_plain(gen, cuda_device, k):
    from xlayer_prover_tpu_torch.ops import fr_poly
    for n in (1, k, k + 1, 5000, 1 << 16):
        p = _fr_words(gen, n, cuda_device)
        before = kernels.LAUNCHES["fr_div_binomial"]
        q, r = fr_poly.div_binomial(p, k, 987654321)
        assert kernels.LAUNCHES["fr_div_binomial"] == before + 1
        pq, pr = fr_poly._div_binomial_plain(p, k, 987654321)
        assert torch.equal(q, pq) and torch.equal(r, pr)


def test_fr_scan_mul_kernel_matches_plain(gen, cuda_device):
    from xlayer_prover_tpu_torch.ops import fr_poly
    for n in (1, 16, 17, 300, 1 << 16):
        x = _fr_words(gen, n, cuda_device)
        for exclusive in (False, True):
            before = kernels.LAUNCHES["fr_scan_mul"]
            got = fr_poly.scan_mul(x, exclusive, 777)
            assert kernels.LAUNCHES["fr_scan_mul"] == before + 1
            assert torch.equal(got, fr_poly._scan_mul_plain(x, exclusive,
                                                            777, None))
            got = fr_poly.scan_mul(x[-1:], exclusive, 5, n=n + 3)
            assert torch.equal(got, fr_poly._scan_mul_plain(
                x[-1:], exclusive, 5, n + 3))


def test_fr_pointwise_kernel_matches_plain(gen, cuda_device):
    from xlayer_prover_tpu_torch.ops import fr_poly, ntt_fr
    for bits in (0, 4, 16):
        n = 1 << bits
        ins = [_fr_words(gen, n, cuda_device) for _ in range(9)]
        ks = [3, 2 ** 250 + 1, 1, 99]
        lens = [ins[0], ins[1][:max(1, n // 2)], ins[2][:1], ins[3]]
        before = kernels.LAUNCHES["fr_pointwise"]
        got = fr_poly.pointwise("lincomb", lens, ks)
        assert kernels.LAUNCHES["fr_pointwise"] == before + 1
        assert torch.equal(got, fr_poly._pointwise_plain("lincomb", lens, ks,
                                                         1, 0))
        assert torch.equal(fr_poly.pointwise("mul", ins[:2], [7]),
                           fr_poly._pointwise_plain("mul", ins[:2], [7], 1,
                                                    0))
        assert torch.equal(fr_poly.pointwise("gate", ins),
                           fr_poly._pointwise_plain("gate", ins, [], 1, 0))
        w = ntt_fr.root_of_unity(bits)
        for g, f in zip(fr_poly.pointwise("perm_z", ins[:6], [5, 6], w),
                        fr_poly._pointwise_plain("perm_z", ins[:6], [5, 6],
                                                 w, 0)):
            assert torch.equal(g, f)
        assert torch.equal(
            fr_poly.pointwise("perm_t2", ins[:7], [5, 6], w, 8 % n),
            fr_poly._pointwise_plain("perm_t2", ins[:7], [5, 6], w, 8 % n))


def test_fflonk_on_cuda_equals_cpu(cuda_device):
    """Setup and proof of a seeded circuit (n = 2^7) with random.Random(5)
    on the card and on the CPU: the same keys and proof, verified."""
    import random

    from xlayer_prover_tpu_torch.snark import fflonk, plonk
    r1cs, wit = plonk.seeded_r1cs(3, 20)
    arr = plonk.r1cs_to_arrays(r1cs, wit)
    pubs = wit[1:1 + r1cs.n_public]
    results = []
    for dev in (cuda_device, "cpu"):
        rng = random.Random(5)
        pk, vk = fflonk.setup(arr, rng=rng, device=dev)
        proof = fflonk.prove(pk, arr, pubs, rng=rng)
        results.append((fflonk.key_digests(fflonk.key_to_host(pk)),
                        fflonk.to_json(vk, proof, pubs)))
        assert fflonk.verify(vk, proof, pubs)
    assert results[0] == results[1]
