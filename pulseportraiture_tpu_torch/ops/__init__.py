"""Batched portrait operations on torch tensors."""
