# Copy of zksnap_tpu/trace/__init__.py: jax-free; goes once zksnap_tpu imports jax lazily.
from .checker import ConstraintError, check
from .context import Cell, Context
