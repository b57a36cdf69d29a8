"""Checkpointing, ported (``repro.checkpoint``)."""
