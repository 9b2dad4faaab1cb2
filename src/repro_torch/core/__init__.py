"""Core of Q-GADMM: quantizer and GADMM configuration, worker topologies."""
