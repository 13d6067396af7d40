"""The harness on the test-only cell with three logUp columns
(tests/cells, `arith_k7_lookups3`: the arithmetic chain at K=7, 250 terms
of one lookup each over lookup columns of 120 rows, so three of them and
a quotient extended 2^3, as in voter_enc_k18), on the CPU, with every
commit on the fixed-base path as every commit of voter_enc_k18 is (the
policy's lower size moved to 2^7, c = 8: a variable-base K=7 commit
costs about 2.5 s here, a fixed-base one 0.4 s).  run.py's main, with
the program in this process, reads `correct` with all six counts 0; a
witness that breaks one gate (the control) reads proofs_rejected 1 and a
record with one lookup dropped reads shape_wrong 1 (and vk_wrong, the
fixed columns moving with it), neither correct.
About seven minutes on one core.  Tolerance: none, all counts exact."""

import dataclasses
import json
import os

import pytest

from portbench import control, generator, run
from portbench.reference.check import Reference

CELLS = os.path.join(os.path.dirname(__file__), "cells")
CELL = "arith_k7_lookups3.prove"
SEED = 2**31 + 4099
COUNTS = ("instances_wrong", "shape_wrong", "vk_wrong", "proofs_rejected",
          "proofs_repeated", "proofs_missing")


@pytest.fixture(scope="module")
def fixed_base_k7():
    from zksnap_tpu_torch.prover import poly_device

    fb = poly_device._FB_STATE
    saved = fb["min_n"], fb["c"]
    fb.update(min_n=1 << 7, c=8)
    fb["tables"].clear()
    yield
    fb["min_n"], fb["c"] = saved
    fb["tables"].clear()


@pytest.fixture(scope="module")
def k7(fixed_base_k7):
    setup = run.prepare(run.Bench(CELLS), CELL, SEED, "cpu")
    ref = Reference(setup.config, setup.inputs, setup.record, setup.device)
    return dict(setup=setup, ref=ref,
                program={"instances": setup.instances,
                         "vk": setup.program_vk})


def _counts(checks):
    return {n: v for n, v, _ in checks}


def test_sound_run_is_correct(fixed_base_k7, capsys):
    assert run.main(["--workload", CELL, "--cells", CELLS, "--seed",
                     str(SEED), "--seconds", "0.001", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 1
    assert {n: c["value"] for n, c in res["checks"].items()} == dict.fromkeys(
        COUNTS, 0)


@pytest.mark.parametrize("fault", ["broken_witness", "dropped_lookup"])
def test_fault_is_not_correct(k7, fault):
    setup = k7["setup"]
    if fault == "broken_witness":
        cells = control.unsatisfied_class(setup.record)
        limbs = setup.pk.layout.advice_limbs
        control.shift_cells(limbs, cells, 1)
        try:
            bad = setup.prove(generator.request_rng(SEED, 2))
        finally:
            control.shift_cells(limbs, cells, -1)
        got = _counts(k7["ref"].judge(k7["program"], [bad]))
        assert got == dict.fromkeys(COUNTS, 0) | {"proofs_rejected": 1}
    else:
        record = dataclasses.replace(setup.record)
        record.lookups = record.lookups[1:]
        ref = Reference(setup.config, setup.inputs, record, setup.device)
        got = _counts(ref.judge(k7["program"], []))
        # the lookup count differs, and so do the fixed columns it moves
        assert got["shape_wrong"] == 1 and got["vk_wrong"] >= 1
