"""Roofline terms of the port's steps (torch port of ``repro.roofline``):
the H100 hardware table and the per-op formulas (``analysis``), and the
counting pass over eager torch that takes the place of the reference's
HLO walk (``walk``)."""
