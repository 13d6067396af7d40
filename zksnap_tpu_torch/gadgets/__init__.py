# Copy of zksnap_tpu/gadgets/__init__.py: jax-free; goes once zksnap_tpu imports jax lazily.
from .bigint import AssignedBigUint, BigUintChip, decompose_canonical, less_than_field
from .imt import AssignedIMTLeaf, insert_leaf
from .merkle import dual_mux, verify_membership_proof
from .paillier_gadget import EncryptionPublicKeyAssigned, PaillierChip
from .poseidon_gadget import PoseidonGadget
