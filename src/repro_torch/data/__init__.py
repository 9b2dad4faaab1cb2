"""Synthetic data and the per-worker shard loader (numpy)."""
