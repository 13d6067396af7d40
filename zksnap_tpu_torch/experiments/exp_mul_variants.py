"""Montgomery-multiply variants (kernel K9): which structure of the product
runs fastest?

PyTorch counterpart of scripts/exp_mul_variants.py, modulus BN254 Fq,
operands limb-major [16, n] (16-bit limbs in int32):

  A: the production kernel K1 (csrc/mont.cu, 8x32-bit CIOS) on the same
     values in the port's [n, 16] rows;
  B: the TPU experiment's 16-bit schoolbook and word REDC, one thread an
     element, fully unrolled (csrc/exp_mul_variants.cu);
  C: B with rolled loops: the columns in local memory (the TPU's dead end:
     Mosaic could not lower it);
  B chain xn: n dependent products a thread, the compute-bound rate.

`mul_limb_major` launches B, C and the chains on CUDA tensors and runs its
plain version on CPU tensors; `mul_limb_major.launches` counts launches.

    python -m zksnap_tpu_torch.experiments.exp_mul_variants [--log-n 20]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..fields import bn254_fq
from ..fields.pallas_mont import mont_mul
from .common import (as_u32, bench, check_device, conv_schoolbook,
                     device_name, first_call, limb_major, parser,
                     to_i32_bits, u32_tensor, word_redc)

FQ = bn254_fq()
VARIANTS = ("A", "B", "C")
CHAINS = (4, 18, 40)


def mul_limb_major_plain(a: torch.Tensor, b: torch.Tensor, p: int,
                         n_muls: int = 1) -> torch.Tensor:
    """The plain version of variants B, C and the chains: `mul_b` of the
    script, n_muls times on the running product."""
    x, y = as_u32(a), as_u32(b)
    for _ in range(n_muls):
        x = word_redc(conv_schoolbook(x, y), p)
    return to_i32_bits(x)


def mul_limb_major(a: torch.Tensor, b: torch.Tensor, p: int,
                   rolled: bool = False, n_muls: int = 1) -> torch.Tensor:
    """n_muls dependent Montgomery products x <- x * b * 2^-256 mod p (one
    conditional subtract each), x = a at first, over [16, n] limb-major
    int32 operands of 16-bit limbs (kernel K9: variant B, or C if
    `rolled`)."""
    n = limb_major(a, "a")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"operands {tuple(a.shape)} on {a.device} and "
                         f"{tuple(b.shape)} on {b.device}")
    if n_muls < 1:
        raise ValueError(f"n_muls = {n_muls}")
    if check_device(a) == "cpu":
        return mul_limb_major_plain(a, b, p, n_muls)
    from .. import kernels

    out = torch.empty_like(a)
    with kernels.on_device(a, b, out) as stream:
        err = kernels.library().zk_exp_mul16(
            kernels.operand(a, torch.int32, (16, n)),
            kernels.operand(b, torch.int32, (16, n)),
            kernels.operand(out, torch.int32, (16, n)), n, n_muls,
            int(rolled), kernels.mod16_ptr(p), stream)
    kernels.check(err, "zk_exp_mul16")
    mul_limb_major.launches += 1
    return out


mul_limb_major.launches = 0


def variant_a(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Variant A: K1 on the same values in [n, 16] rows, back to [16, n]."""
    out = mont_mul(a.t().contiguous(), b.t().contiguous(), FQ.p)
    return out.t().contiguous()


def make_variant(name: str, n_muls: int = 1, device="cuda"):
    """A function of (a, b), [16, n] limbs (numpy uint32 or torch int32),
    moved to `device`: variant A, B or C, or B chained n_muls times."""
    if name not in VARIANTS or (name != "B" and n_muls != 1):
        raise ValueError(f"variant {name!r} with n_muls = {n_muls}")

    def go(a, b):
        a, b = u32_tensor(a, device), u32_tensor(b, device)
        if name == "A":
            return variant_a(a, b)
        return mul_limb_major(a, b, FQ.p, rolled=name == "C", n_muls=n_muls)

    return go


def main(argv=None) -> dict:
    """Time A, B, C at n = 2^log_n and B's chains at n / 4, print the
    script's lines, and check B and C against A; returns {name: {"ms",
    "mop_s", "first_s"}, "B == A": bool, "C == A": bool}."""
    ap = parser("exp_mul_variants", __doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20)
    args = ap.parse_args(argv)
    device, n = args.device, 1 << args.log_n
    print(f"exp_mul_variants on {device_name(device)}", flush=True)
    rng = np.random.default_rng(0)
    a_host = rng.integers(0, 1 << 16, (16, n), dtype=np.uint32)
    b_host = rng.integers(0, 1 << 16, (16, n), dtype=np.uint32)
    a_host[-1] &= 0x2FFF  # keep < p: the top limb below p's
    b_host[-1] &= 0x2FFF
    a, b = u32_tensor(a_host, device), u32_tensor(b_host, device)
    res, outs = {}, {}

    def run(label, key, fn, args_, n_ops):
        out, first_s = first_call(fn, args_, device)
        dt = bench(fn, args_, device, 20)
        res[key] = {"ms": dt * 1e3, "mop_s": n_ops / dt / 1e6,
                    "first_s": first_s}
        print(f"{label}: first call {first_s:.1f}s, {dt*1e3:.4f} ms, "
              f"{n_ops/dt/1e6:.0f} Mop/s", flush=True)
        return out

    for name, label in (("A", "A baseline  "), ("B", "B stacked   "),
                        ("C", "C rolled    ")):
        outs[name] = run(label, name, make_variant(name, device=device),
                         (a, b), n)
    for name in ("B", "C"):
        res[f"{name} == A"] = bool(torch.equal(outs[name], outs["A"]))
        print(f"  {name} == A: {res[f'{name} == A']}", flush=True)
    q = n // 4
    aq, bq = a[:, :q].contiguous(), b[:, :q].contiguous()
    for k in CHAINS:
        run(f"B chain x{k:2d}", f"B x{k}", make_variant("B", k, device),
            (aq, bq), q * k)
    return res


if __name__ == "__main__":
    r = main(sys.argv[1:])
    sys.exit(0 if r["B == A"] and r["C == A"] else 1)
