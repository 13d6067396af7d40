"""The reference that decides `correct`, at K=7 on the CPU, on the
test-only cell tests/cells (the arithmetic chain), through the harness's
own set-up: it accepts the program's proof, rejects the proof with one
byte flipped anywhere, a proof for other instances and a witness that
breaks a constraint (the control), and counts a key that differs and a
record with a constraint dropped.  Its field arithmetic is held to python
ints.  Tolerance: none, all exact."""

import dataclasses
import os
import random

import pytest

from portbench import control, generator, run
from portbench.natives.curve import BN254_G1
from portbench.reference import fr
from portbench.reference.check import Reference

CELLS = os.path.join(os.path.dirname(__file__), "cells")
CELL = "arith_k7.prove"
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def k7():
    setup = run.prepare(run.Bench(CELLS), CELL, SEED, "cpu")
    ref = Reference(setup.config, setup.inputs, setup.record, setup.device)
    proof = setup.prove(generator.request_rng(SEED, 0))
    program = {"instances": setup.instances, "vk": setup.program_vk}
    return dict(setup=setup, ref=ref, proof=proof, program=program)


def _counts(checks):
    return {n: v for n, v, _ in checks}


def test_reference_accepts_the_port_proof(k7):
    got = _counts(k7["ref"].judge(k7["program"], [k7["proof"]]))
    assert got == dict.fromkeys(got, 0)


@pytest.mark.parametrize("where", [0, 100, 0.5, -1])
def test_reference_rejects_a_flipped_byte(k7, where):
    p = bytearray(k7["proof"])
    i = int(where * len(p)) if isinstance(where, float) else where
    p[i] ^= 0x01
    got = _counts(k7["ref"].judge(k7["program"], [bytes(p)]))
    assert got["proofs_rejected"] == 1


def test_reference_rejects_a_truncated_proof(k7):
    got = _counts(k7["ref"].judge(k7["program"], [k7["proof"][:-32]]))
    assert got["proofs_rejected"] == 1


def test_reference_counts_wrong_instances_and_key(k7):
    program = dict(k7["program"])
    program["instances"] = [k7["program"]["instances"][0] + 1]
    vk = dict(program["vk"])
    comm = dict(vk["commitments"])
    x, y = comm["sigma_0"]
    comm["sigma_0"] = (x, (-y) % BN254_G1.p)  # the point's negative
    vk["commitments"] = comm
    program["vk"] = vk
    got = _counts(k7["ref"].judge(program, [k7["proof"]]))
    assert got["instances_wrong"] == 1 and got["vk_wrong"] == 1


@pytest.mark.parametrize("part", ["gates", "copies", "const_idx", "lookups"])
def test_reference_counts_a_dropped_constraint(k7, part):
    setup = k7["setup"]
    record = dataclasses.replace(setup.record)
    setattr(record, part, getattr(record, part)[1:])
    if part == "const_idx":
        record.const_vals = record.const_vals[1:]
    ref = Reference(setup.config, setup.inputs, record, setup.device)
    assert _counts(ref.judge(k7["program"], []))["shape_wrong"] >= 1


def test_control_and_planted_faults_fail(k7):
    r = control.readings(k7["setup"], k7["ref"], SEED)
    assert r["control_cells"] >= 1
    honest, stale = _counts(r["honest"]), _counts(r["stale"])
    altered, ctl = _counts(r["altered"]), _counts(r["control"])
    assert honest == dict.fromkeys(honest, 0)
    assert stale["proofs_repeated"] == 1 and stale["proofs_rejected"] == 0
    assert altered["proofs_rejected"] == 1
    assert ctl["proofs_rejected"] == 1


def test_field_vectors_match_python_ints():
    rng = random.Random(7)
    p = fr.P
    xs = [0, 1, p - 1] + [rng.randrange(p) for _ in range(200)]
    ys = [p - 1, p - 1, 2] + [rng.randrange(p) for _ in range(200)]
    a, b = fr.from_ints(xs, "cpu"), fr.from_ints(ys, "cpu")
    assert fr.to_ints(fr.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
    assert fr.to_ints(fr.sub(a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    nz = [x for x in xs if x]
    assert fr.to_ints(fr.batch_inverse(fr.from_ints(nz, "cpu"))) == [
        pow(x, -1, p) for x in nz]
    assert fr.total(a) == sum(xs) % p
    k, tau = 6, rng.randrange(p)
    w, n = fr.omega(k), 1 << k
    want = [pow(w, i, p) * (pow(tau, n, p) - 1) * pow(n * (tau - pow(w, i, p)),
                                                       -1, p) % p
            for i in range(n)]
    assert fr.to_ints(fr.lagrange_at(tau, k, "cpu")) == want
