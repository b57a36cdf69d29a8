"""Training substrate, ported (``repro.train``): the optimizer so far."""
