"""Kernel wrappers (CUDA on the card, plain PyTorch on the CPU) and the
public ops over them."""
