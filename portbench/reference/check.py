"""The comparison that decides a run's `correct`.

It takes the benchmark's inputs, the raw record of the synthesized circuit
(the hand-off from synthesis to keygen, see layout.Record), what the
program produced (its public instances, its verifying key as plain
numbers and points) and every proof of the measured window, and counts
faults; each count's limit is 0, since every comparison is exact:

- instances_wrong: public instances that differ from those the reference
  works out from the inputs (a length difference counts each missing one);
- shape_wrong: numbers of the circuit's shape that differ from those the
  configuration states: the raw record's own counts (advice cells, gates,
  equality pairs, constants, range checks), the columns and the quotient's
  extension.  The key below is derived from the record that the program's
  synthesis made, so these counts are what holds that record to the
  circuit: a constraint dropped or added changes one of them;
- vk_wrong: numbers and commitments of the program's verifying key that
  differ from the key the reference derives from the record and the
  set-up's seed;
- proofs_rejected: window proofs that do not verify, under the
  reference's key and instances;
- proofs_repeated: window proofs equal to an earlier one (each proof
  draws fresh blinding, so two equal proofs mean one was not made);
- proofs_missing: 1 when the window finished no proof.

Imports: numpy, scipy, torch and the benchmark's own plain code only.
"""

from __future__ import annotations

import importlib
import time

from ..natives.curve import BN254_G1, AffinePoint
from . import layout, verifier

VK_NUMBERS = ("k", "ext_log", "n_advice", "n_lookup", "lookup_bits",
              "n_perm", "n_z", "usable", "deltas", "num_instance", "omega")


def _point(xy):
    return (AffinePoint.identity(BN254_G1) if xy is None
            else AffinePoint(BN254_G1, xy[0], xy[1]))


def vk_differences(ref: verifier.VK, prog: dict) -> int:
    bad = sum(getattr(ref, f) != prog.get(f) for f in VK_NUMBERS)
    pc = prog.get("commitments", {})
    for name in set(ref.commitments) | set(pc):
        if name not in ref.commitments or name not in pc:
            bad += 1
        elif ref.commitments[name] != _point(pc[name]):
            bad += 1
    return bad


class Reference:
    """What the reference works out once for a run: the instances, the
    fixed columns and the verifying key."""

    def __init__(self, config: dict, inputs, record: layout.Record, device):
        self.seconds = {}
        t = time.perf_counter()
        kind = importlib.import_module(f"{__package__}.circuits."
                                       f"{config['circuit']}")
        self.instances = kind.expected_instances(config, inputs)
        fixed = layout.fixed_columns(record, config["k"])
        self.seconds["layout"] = time.perf_counter() - t
        shape = {"advice_cells": record.n_cells,
                 "gates": len(record.gates), "copies": len(record.copies),
                 "constants": len(record.const_idx),
                 "lookups": len(record.lookups), "n_advice": fixed.n_advice,
                 "n_lookup": fixed.n_lookup, "n_perm": fixed.n_perm,
                 "ext_log": fixed.ext_log,
                 "num_instance": len(self.instances)}
        self.shape_bad = sum(shape[key] != v
                             for key, v in config["shape"].items())
        self.tau = verifier.tau_from_seed(config["srs_seed"])
        t = time.perf_counter()
        self.vk = verifier.derive_vk(fixed, self.tau, len(self.instances),
                                     device)
        self.seconds["vk"] = time.perf_counter() - t

    def judge(self, program: dict, proofs: list) -> list:
        """[(name, count, limit)] in a fixed order."""
        got = list(program["instances"])
        inst_bad = (sum(a != b for a, b in zip(self.instances, got))
                    + abs(len(self.instances) - len(got)))
        t = time.perf_counter()
        rejected = sum(not verifier.verify(self.vk, self.tau, self.instances,
                                           p) for p in proofs)
        self.seconds["verify"] = time.perf_counter() - t
        return [("instances_wrong", inst_bad, 0),
                ("shape_wrong", self.shape_bad, 0),
                ("vk_wrong", vk_differences(self.vk, program["vk"]), 0),
                ("proofs_rejected", rejected, 0),
                ("proofs_repeated", len(proofs) - len(set(proofs)), 0),
                ("proofs_missing", int(not proofs), 0)]


