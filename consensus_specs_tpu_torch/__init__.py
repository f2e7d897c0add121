"""PyTorch/CUDA port of consensus_specs_tpu's device core.

The JAX package `consensus_specs_tpu` stays the reference; this package
mirrors its module paths (ops/sha256.py, utils/ssz/incremental.py,
models/phase0/epoch_soa.py, ...) so each function has a counterpart under
the same name. It imports torch and numpy, never JAX and nothing of the
reference package.

Conventions:
  * Entry points take `device=` and default to "cuda"; without CUDA they
    raise (device.resolve) instead of running on the CPU. Tests pass
    device="cpu".
  * SHA-256 words are int32 tensors holding uint32 bit patterns, in the
    reference's public layout ([N, 16] message words in, [N, 8] out).
  * uint64 columns are int64 tensors holding the uint64 bit patterns;
    ops/intmath.py has the unsigned compare, sort key and logical shift.
  * BLS field elements are int64 tensors of the reference's lazy signed
    29-bit limbs ([..., 14]; Fq2 [..., 2, 14]; Fq12 [..., 2, 3, 2, 14]),
    compared with it bit for bit.
  * Hand-written kernels: csrc/sha256_pairs.cu, the pair hash behind
    ops.sha256.pair_hash_words, and csrc/fq_mont.cu, the Montgomery
    multiply and REDC behind ops.fq.fq_mul / fq_redc. Each is launched for
    every CUDA tensor; its plain PyTorch twin runs only for CPU tensors
    and in the checks.
"""
