from .common import (
    LIMB_BITS,
    LIMB_MASK,
    N_LIMBS,
    int_to_limbs,
    ints_to_limbs,
    limbs_to_int,
    limbs_to_ints,
)
from .field import (
    BN254_FQ_MOD,
    BN254_FR_MOD,
    SECP_N,
    SECP_P,
    PrimeField,
    bn254_fq,
    bn254_fr,
    secp256k1_fp,
    secp256k1_fq,
)

__all__ = [
    "LIMB_BITS",
    "LIMB_MASK",
    "N_LIMBS",
    "int_to_limbs",
    "ints_to_limbs",
    "limbs_to_int",
    "limbs_to_ints",
    "PrimeField",
    "BN254_FQ_MOD",
    "BN254_FR_MOD",
    "SECP_N",
    "SECP_P",
    "bn254_fq",
    "bn254_fr",
    "secp256k1_fp",
    "secp256k1_fq",
]
