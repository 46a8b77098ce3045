"""PyTorch/CUDA port of the FedML-HE reproduction (the JAX package `repro`
is the reference).

Residues are int32 tensors; the four kernels of the Algorithm 1 round
(ntt_fwd, ntt_inv, mul_add, weighted_sum) are hand-written CUDA for Hopper
under `kernels/csrc/`.  Entry points run on CUDA unless given
device="cpu".
"""
