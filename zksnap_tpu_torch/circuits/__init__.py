# Copy of zksnap_tpu/circuits/__init__.py: jax-free; goes once zksnap_tpu imports jax lazily.
from .state_transition import state_transition_circuit
from .voter import VoterFlags, voter_circuit
