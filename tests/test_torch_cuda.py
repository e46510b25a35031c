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
from xlayer_prover_tpu_torch.ops import merkle, poseidon_bn254, poseidon_gl
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


def _fr_states(gen, n, t):
    vals = [int.from_bytes(gen.bytes(32), "little") for _ in range(n * t)]
    for k, e in enumerate(FR_EDGES):
        vals[k * t:(k + 1) * t] = [e] * t
    return vals, torch.from_numpy(
        poseidon_bn254.to_limbs(vals).view(np.int64)).reshape(n, t, 4)


@pytest.mark.parametrize("t", [2, 3, 5, 9, 14, 17])
def test_bn254_permute_kernel_matches_plain(gen, cuda_device, t):
    vals, states = _fr_states(gen, 300, t)
    x = states.to(cuda_device)
    before = kernels.LAUNCHES["poseidon_bn254_permute"]
    got = poseidon_bn254.permute(x, t)
    assert kernels.LAUNCHES["poseidon_bn254_permute"] == before + 1
    assert torch.equal(got, poseidon_bn254._permute_plain(x, t))
    for k in (0, 3, 5, 7):
        assert poseidon_bn254.from_limbs(gl.to_u64_np(got[k])) == \
            poseidon_bn254.host_permute(vals[k * t:(k + 1) * t])
    with pytest.raises(ValueError):
        poseidon_bn254.permute(x[:, :, :2].contiguous(), t)


@pytest.mark.parametrize("width", [0, 3, 4, 5, 48, 60, 519])
def test_bn254_leaf_hash_kernel_matches_plain(gen, cuda_device, width):
    rows = gen.integers(0, 1 << 64, size=(300, width), dtype=np.uint64,
                        endpoint=False)
    if width:
        rows[:EDGES.size] = EDGES[:, None]
    t = gl.from_u64_np(rows, cuda_device)
    before = kernels.LAUNCHES["poseidon_bn254_leaf_hash"]
    got = poseidon_bn254.leaf_hash(t, width)
    assert kernels.LAUNCHES["poseidon_bn254_leaf_hash"] == before + 1
    assert torch.equal(got, poseidon_bn254._leaf_hash_plain(t, width))
    assert poseidon_bn254.from_limbs(gl.to_u64_np(got[11:13])) == [
        poseidon_bn254.leaf_hash_host([int(v) for v in rows[k]])
        for k in (11, 12)]


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
