"""Gating and the one-rank MoE layer of the port."""
