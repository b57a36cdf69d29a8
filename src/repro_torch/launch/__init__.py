"""Entry points of the port that a user runs (``serve``)."""
