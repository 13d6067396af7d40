"""Launches of K1 (mont_mul) and K2 (mont_addsub) a proof over the window:
the program's own counters on its field kernel wrappers."""

COUNTERS = ("zksnap_tpu_torch.fields.pallas_mont:mont_mul",
            "zksnap_tpu_torch.fields.pallas_mont:mont_addsub")


def read(run):
    if run.device != "cuda" or not run.proofs:
        return None
    return sum(run.counters[c] for c in COUNTERS) / run.proofs
