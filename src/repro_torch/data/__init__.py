"""Training data, ported (``repro.data``): the synthetic LM pipeline."""
