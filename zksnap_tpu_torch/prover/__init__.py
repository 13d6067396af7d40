from .accumulator import (
    KzgAccumulator,
    accumulator_from_proof,
    decide,
    fold_accumulators,
)
from .plonk import (
    ProvingKey,
    VerifyingKey,
    keygen,
    prove,
    rebind_witness,
    verify,
    verify_succinct,
)
from .recursion import RecursionChain, Snark, accumulator_limbs
from .serialize import (
    load_pk,
    load_vk,
    proof_from_bytes,
    proof_to_bytes,
    save_pk,
    save_vk,
)
from .srs import SRS, gen_srs, load_srs, save_srs, srs_sanity_check
from .transcript import Transcript
