"""The mini-ROM: a small zkASM program covering the Main SM constraint
surface.

A copy of the program of the JAX package's zkEVM proof test
(``tests/test_zkevm_proof.py``): setters, CONST/CONSTL, all jump forms,
call/return, repeat, binary ops (ADD with carry, LT, EQ), a memory
write/read pair, an arithEq0 mul-add and an assert.  It executes in 24
steps and reaches neither the storage operations nor the hash chains.

``execute`` runs it through ``Executor.execute`` at one of two
geometries of the zkEVM composite AIR (``GEOMETRIES``): 13, the JAX
package's zkEVM proof test (``tests/test_zkevm_proof.py``), and 16, its
devnet batch proofs (``tools/run_a7_cascade.py``: 2^16 rows, chunk_bits
4, limb_bits 16, 4 queries).
"""

from __future__ import annotations

from ...executor.rom import Rom

GEOMETRIES = {
    13: dict(n_bits=13, chunk_bits=2, limb_bits=8, n_queries=4,
             max_steps=1 << 12),
    16: dict(n_bits=16, chunk_bits=4, limb_bits=16, n_queries=4,
             max_steps=1 << 15),
}


def mini_rom() -> Rom:
    """A small program covering the Main SM constraint surface."""
    prog = []

    def line(**kw):
        prog.append(kw)
        return len(prog) - 1

    labels = {}
    labels["start"] = line(CONSTL=5, setA=1)                  # A = 5
    line(CONSTL=7, setB=1)                                    # B = 7
    line(CONSTL=2, setC=1)                                    # C = 2
    # binary ADD via Binary SM: D = A + B = 12
    line(freeInTag={}, inFREE=1, bin=1, binOpcode=0, setD=1)
    # memory write: mem[10] = D
    line(inD=1, mOp=1, mWR=1, offset=10)
    # memory read into E
    line(freeInTag={}, inFREE=1, mOp=1, offset=10, setE=1)
    # JMPZ taken: op = E - 12 == 0
    t0 = line(inE=1, CONST=-12, JMPZ=1, useJmpAddr=1, jmpAddr=None)
    line(CONSTL=999, setA=1)             # skipped
    prog[t0]["jmpAddr"] = len(prog)
    # arith eq0: A*B + C = 0*2^256 + 37 (D must hold the high part, 0)
    line(CONSTL=0, setD=1)
    line(freeInTag={"op": "number", "num": 37}, inFREE=1, arithEq0=1,
         setA=1)                          # A = 37
    line(CONSTL=37, **{"assert": 1})      # assert A == 37
    # JMPN taken on negative
    t1 = line(CONST=-1, JMPN=1, useJmpAddr=1, jmpAddr=None)
    line(CONSTL=998, setA=1)             # skipped
    prog[t1]["jmpAddr"] = len(prog)
    # binary LT: A=37 < B=7? no -> carry 0, JMPC falls through
    line(freeInTag={}, inFREE=1, bin=1, binOpcode=2, setD=1)
    line(JMPC=1, useJmpAddr=1, jmpAddr=0)   # not taken
    # binary EQ: B == B -> carry 1, JMPC taken
    line(inB=1, setA=1)                  # A = B
    line(freeInTag={}, inFREE=1, bin=1, binOpcode=4, setD=1)
    t3 = line(JMPC=1, useJmpAddr=1, jmpAddr=None)
    line(CONSTL=997, setA=1)             # skipped
    prog[t3]["jmpAddr"] = len(prog)
    # call / return
    t4 = line(call=1, useJmpAddr=1, jmpAddr=None)
    # repeat: RCX = 3, decrement to zero on one line
    line(CONST=3, setRCX=1)
    line(repeat=1, inRCX=1)
    jmp_end = line(JMP=1, useJmpAddr=1, jmpAddr=None)
    # the called subroutine
    prog[t4]["jmpAddr"] = len(prog)
    line(CONSTL=1, setE=1)
    line(**{"return": 1})
    # finalize
    prog[jmp_end]["jmpAddr"] = len(prog)
    labels["finalizeExecution"] = len(prog)
    line()   # the stop line itself (never executed)
    return Rom.from_json({"program": prog, "labels": labels,
                          "constants": {}})


def execute(n_bits: int):
    """The mini-ROM executed at ``GEOMETRIES[n_bits]`` -> (executor,
    ExecutionResult with const_np, cm1_np and publics)."""
    from ...executor.executor import Executor
    ex = Executor(mini_rom(), **GEOMETRIES[n_bits])
    return ex, ex.execute()
