"""PyTorch/CUDA port of the FedML-HE reproduction (the JAX package `repro`
is the reference).

Residues are int32 tensors; the kernels (ntt_fwd, ntt_inv, mul_add,
weighted_sum, weighted_accum, weighted_accum_chunks, mod_lift) are
hand-written CUDA for Hopper under `kernels/csrc/`.  Entry points run on
CUDA unless given device="cpu"; `core.ckks.sharded` runs them over a mesh
of devices (`launch.mesh`).  `models`, `optim`, `data` and
`core.sensitivity` hold the model families (transformer, mamba2, zamba2),
AdamW, the synthetic client streams and the sensitivity maps; `fl` the FL
client, server and orchestrator (paper Figure 3) and `serve.quorum` its
weight law.
"""
