"""repro_torch.membership — the gossip membership plane, ported.

  gossip   — SWIM failure detection and push dissemination over an overlay
             (``confirmed_leave_time`` feeds the churn engine)
  elastic  — rescale plans and straggler detection over the live fleet

Host numpy, as in ``repro.membership``; the same seeds give the same times,
plans and rings.
"""
