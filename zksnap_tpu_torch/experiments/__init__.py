"""The experiment scripts of the JAX package, ported with their kernels.

PyTorch counterparts of scripts/exp_vpu_rates.py (kernel K11, op-rate
probes), scripts/exp_mul_variants.py (kernel K9, Montgomery-multiply
variants) and scripts/exp_mul_mxu.py (kernel K10, Karatsuba products and a
REDC on the tensor cores).  Each module has the script's entry points, with
`device="cuda"` by default, and a `main(argv)` that takes the script's own
arguments plus `--device` and prints the script's lines:

    python -m zksnap_tpu_torch.experiments.exp_vpu_rates [w_log] [chain]
    python -m zksnap_tpu_torch.experiments.exp_mul_variants [--log-n N]
    python -m zksnap_tpu_torch.experiments.exp_mul_mxu [batch_log2] [variants]

As everywhere in the port, a wrapper launches its kernel on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor.  Nothing in the prover
calls these modules.
"""
