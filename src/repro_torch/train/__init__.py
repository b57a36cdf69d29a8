"""Training substrate, ported (``repro.train``): the optimizer and the LM
training step.  ``collectives`` and ``pod_compress`` are not ported yet
(ROADMAP Queue A item 13f)."""
