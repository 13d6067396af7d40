"""zksnap_tpu_torch -- the PyTorch + CUDA port of zksnap_tpu for NVIDIA
Hopper (H100).

Same module paths as the JAX package, which stays the reference:

- ``fields``   -- Montgomery limb arithmetic; kernels K1 (multiply) and K2
                  (add / sub) in ``fields/pallas_mont.py``.
- ``curves``   -- batched group law (Jacobian and RCB projective); kernels
                  K3 (point ops) and K4 (bucket scan) in ``curves/fused.py``.
- ``poly``     -- evaluation domains, the radix-2 NTT and the mesh-sharded
                  four-step NTT.
- ``msm``      -- Pippenger and fixed-base multi-scalar multiplication.
- ``prover``   -- SRS, keygen, the PLONK-KZG prover (on one device or
                  sharded over a mesh), its warm-up and the host verifier.
- ``parallel`` -- device meshes (one controller; a mesh may name one card
                  several times), the sharded MSM, ``torch.distributed``
                  bootstrap, and host pools for witnesses and rounds.
- ``trace``, ``gadgets``, ``circuits``, ``natives``, ``hash`` -- jax-free
  copies of the JAX package's host layer (each file names its source).

Tensors carry 16-bit limbs in ``torch.int32`` [..., 16].  Every kernel
wrapper dispatches on the tensor's device: CUDA launches the hand-written
kernel from ``csrc/`` (built on first use by ``kernels.py``), CPU runs its
plain PyTorch version.  The package imports torch and never jax.
"""

__version__ = "0.1.0"
