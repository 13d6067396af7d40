# Copy of zksnap_tpu/natives/__init__.py: jax-free; goes once zksnap_tpu imports jax lazily.
from .inputs import (
    ENC_BIT_LEN,
    LIMB_BIT_LEN,
    NUM_LIMBS,
    EncryptionPublicKey,
    IndexedMerkleTreeInput,
    StateTransitionInput,
    VoterCircuitInput,
    bytes_le_chunks_to_fr,
    compress_native_nullifier,
    generate_random_voter_circuit_inputs,
    generate_state_transition_circuit_inputs,
    generate_wrapper_circuit_input,
    update_idx_leaf,
)
from .merkle import IMTLeaf, IndexedMerkleTree, MerkleTree, hash_imt_leaf
from .paillier import paillier_add, paillier_enc
from .plume import compress_point, gen_nullifier, verify_nullifier
