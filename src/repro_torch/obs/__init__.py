"""Observability of the port: the trainer's live invariants (``checks``)."""
