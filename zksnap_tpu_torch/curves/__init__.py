# Copy of zksnap_tpu/curves/__init__.py: jax-free; goes once zksnap_tpu imports jax lazily.
from .native import (
    BN254_G1,
    SECP256K1,
    AffinePoint,
    CurveParams,
    bn254_generator,
    secp_generator,
)
