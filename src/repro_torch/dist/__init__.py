"""The decentralized Q-GADMM trainer (single device so far)."""
