# Copy of zksnap_tpu/hash/__init__.py: jax-free; goes once zksnap_tpu imports jax lazily.
from .poseidon import (
    CAP_TAG,
    PoseidonNative,
    PoseidonSpec,
    default_spec,
    hash_fixed_batched,
    hash_fixed_native,
)

__all__ = [
    "CAP_TAG",
    "PoseidonNative",
    "PoseidonSpec",
    "default_spec",
    "hash_fixed_batched",
    "hash_fixed_native",
]
