"""Selective HE aggregation: packing, selection, DP noise, Algorithm 1."""
